"""The plain reference against the port at smoke width, under the segment
mask: the engine's logits at every sampled position of a segmented prompt
(prelude, three documents, a query) equal the reference's, and its greedy
tokens are the reference's best."""
import numpy as np
import pytest
import torch

import tiny
from ragbench import bench, weights
from ragbench.reference import decoder


@pytest.fixture
def captured(monkeypatch):
    import repro_torch.serving.device_runner as dr

    seen = []
    real = dr.sample_tokens

    def spy(generator, logits, temps):
        seen.append(logits[0].detach().float().clone())
        return real(generator, logits, temps)

    monkeypatch.setattr(dr, "sample_tokens", spy)
    return seen


@pytest.mark.parametrize("docs", [(32, 48, 20), (16,)])
def test_reference_matches_the_engine_under_the_segment_mask(captured, docs):
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import assemble_prompt

    m = dict(tiny.MODEL)
    params = weights.draw(m, 3, "cpu")
    rng = np.random.default_rng(0)
    toks = lambda n: rng.integers(0, m["vocab_size"], n).astype(np.int32)
    prelude, ds, query = toks(32), [toks(n) for n in docs], toks(7)
    eng = GenerationEngine(bench.port_config(m), params=params, device="cpu", max_batch=2,
                           max_seq=256, block_size=16, prefill_chunk_size=16, token_budget=24,
                           n_blocks=64, kernel="pallas", ragged=True)
    req = eng.submit(assemble_prompt(query, ds, doc_ids=list(range(len(ds))),
                                     system_tokens=prelude), max_new=6)
    eng.run_until_done()
    served = decoder.Served(prelude, ds, query, np.asarray(req.out_tokens))
    ref = decoder.logits(m, params, [served], "cpu")[0]
    port = torch.stack(captured[-len(req.out_tokens):])[:, : m["vocab_size"]]
    assert torch.allclose(port, ref, atol=1e-4 * float(ref.abs().max()), rtol=0)
    assert decoder.widest_gap([ref], [served.answer]) == 0.0


def test_layout_restarts_document_positions_after_the_prelude():
    s = decoder.Served(np.zeros(4), [np.zeros(3), np.zeros(2)], np.zeros(2), np.zeros(3))
    pos, p_end, s_start = decoder.layout(s)
    assert pos.tolist() == [0, 1, 2, 3, 4, 5, 6, 4, 5, 9, 10, 11, 12]
    assert p_end.tolist() == [0] * 4 + [4] * 5 + [0] * 4
    assert s_start.tolist() == [0] * 4 + [4, 4, 4, 7, 7] + [0] * 4
