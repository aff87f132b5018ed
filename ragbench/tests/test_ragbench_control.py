"""The comparison that decides ``correct`` fails its control and the
faults it is there to catch, at a size a test run holds (smoke width, bf16,
on the CPU): over the same prompts and served tokens, the fp8 control's
widest gap lies above the limit that the program's stays under; a token
altered where the sampler produces it, or a document id altered where
retrieval returns it, makes a whole run's ``correct`` false."""
import numpy as np
import pytest

import tiny
from ragbench import bench, weights
from ragbench.bench import run_cell
from ragbench.reference import decoder
from ragbench.reference.control import control_gap

# The smoke model in bf16. Its limit lies between the program's widest gap
# (0.0017 to 0.0097 over weight seeds 1-12) and the fp8 control's (0.0694
# to 0.1832 over seeds 1-4), both read on the CPU over ``served`` below.
BF16 = dict(tiny.MODEL, torch_dtype="bfloat16")
LIMIT = 0.03


def served(seed):
    """Six segmented requests (a prelude, three of six documents, a query)
    served by the port's engine on the CPU: the weights and the reference's
    inputs."""
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import assemble_prompt

    params = weights.draw(BF16, seed, "cpu")
    rng = np.random.default_rng(seed)
    toks = lambda n: rng.integers(0, BF16["vocab_size"], n).astype(np.int32)
    prelude, docs = toks(32), [toks(32) for _ in range(6)]
    eng = GenerationEngine(bench.port_config(BF16), params=params, device="cpu", max_batch=4,
                           max_seq=512, block_size=16, prefill_chunk_size=64, token_budget=128,
                           n_blocks=128)
    reqs = []
    for _ in range(6):
        pick, q = rng.choice(6, 3, replace=False), toks(6)
        ds = [docs[j] for j in pick]
        prompt = assemble_prompt(q, ds, doc_ids=list(pick), system_tokens=prelude)
        reqs.append((eng.submit(prompt, max_new=16), ds, q))
    eng.run_until_done()
    return params, [decoder.Served(prelude, ds, q, np.asarray(r.out_tokens)) for r, ds, q in reqs]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails_where_the_program_passes(seed):
    params, sample = served(seed)
    ref = decoder.logits(BF16, params, sample, "cpu")
    assert decoder.widest_gap(ref, [s.answer for s in sample]) <= LIMIT
    assert control_gap(BF16, params, sample, "cpu") > LIMIT


def test_an_altered_token_fails(tmp_path, monkeypatch):
    import repro_torch.serving.device_runner as dr

    real = dr.sample_tokens
    calls = []

    def altered(generator, logits, temps):
        toks = real(generator, logits, temps)
        calls.append(1)
        if len(calls) % 3 == 0:  # every third step: every row's token is another
            toks = (toks + 1) % 500
        return toks

    monkeypatch.setattr(dr, "sample_tokens", altered)
    out = run_cell(tiny.tiny_cell(tmp_path), 5, 3.0, False, device="cpu")
    assert out["correct"] is False
    assert out["check"]["logit_gap"]["value"] > out["check"]["logit_gap"]["limit"]


def test_an_altered_document_id_fails(tmp_path, monkeypatch):
    from repro_torch.serving.retrieval import VectorIndex

    real = VectorIndex.search_exact

    def altered(self, query, k=10):
        scores, ids = real(self, query, k)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % self.size
        return scores, ids

    monkeypatch.setattr(VectorIndex, "search_exact", altered)
    out = run_cell(tiny.tiny_cell(tmp_path), 6, 3.0, False, device="cpu")
    assert out["correct"] is False
    assert out["check"]["retrieval_mismatches"]["value"] > 0
