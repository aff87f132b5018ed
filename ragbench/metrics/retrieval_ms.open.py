"""retrieval_ms.open (open-loop cells; ``serving/retrieval.py``
``search_exact`` and the top-k kernel): the mean device time a call, from
CUDA events on the retrieval stream around each call in the window of a
traced run."""

def read(run):
    if run.loop != "open" or not run.retrieval_ms:
        return None
    return sum(run.retrieval_ms) / len(run.retrieval_ms)
