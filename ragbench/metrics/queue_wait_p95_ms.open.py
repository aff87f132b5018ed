"""queue_wait_p95_ms.open (open-loop cells; admission in
``serving/engine.py`` and ``serving/control_plane.py``): the 95th
percentile, over the requests submitted in the window, of the time from
submission to first admission, from the engine's own stamps
(``Request.submitted_at``, ``Request.admitted_at``, on the benchmark's
clock); a request not admitted by the window's end counts at (end -
submitted). None where the engine does not stamp admission."""
from ragbench import stats


def read(run):
    if run.loop != "open":
        return None
    waits = []
    for s in run.sent:
        req = s.req
        if not hasattr(req, "admitted_at"):
            return None
        if run.w0 <= req.submitted_at < run.w1:
            t = req.admitted_at
            waits.append((t if t is not None and t < run.w1 else run.w1) - req.submitted_at)
    v = stats.percentile(waits, 95)
    return None if v is None else 1e3 * v
