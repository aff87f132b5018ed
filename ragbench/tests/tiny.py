"""A cell at smoke width, written as new files under a scratch root: a
configuration, a traffic mix and a ``BENCHMARK.json`` entry, as a later
change adds a cell. The port runs it on the CPU with its plain versions."""
import json

from ragbench import spec

MODEL = {
    "name": "tiny-gqa", "source": "https://example.org/tiny", "model_type": "test",
    "hidden_act": "silu", "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "head_dim": 32, "vocab_size": 500, "rope_theta": 10000.0,
    "max_position_embeddings": 1024, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "qkv_bias": True, "torch_dtype": "float32",
    "engine": {"max_batch": 6, "max_seq": 512, "block_size": 16, "prefill_chunk_size": 64,
               "token_budget": 128, "reserve_gib": 0.0, "n_blocks": 160},
    "correct": {"logit_gap": 1e-3},
}


def traffic(popularity="zipf"):
    return {
        "loop": "open", "arrival": "poisson", "rate_rps": 6.0, "warmup_s": 1.0, "trace_s": 0.5, "pool_seed": 5,
        "answer_tokens": [3, 12], "query_tokens": [4, 8], "prelude_tokens": 32,
        "docs_per_request": [2, 4], "doc_tokens": 32,
        "corpus": {"passages": 2048, "popularity": popularity, "zipf_s": 1.1,
                   "embedding_dim": 64, "query_noise": 0.01},
        "classes": [{"name": "interactive", "weight": 3, "deadline_ms": 4000},
                    {"name": "relaxed", "weight": 1, "deadline_ms": 12000}],
        "ttft_limit_ms": 2000, "check": {"min_tokens": 30, "max_requests": 4},
    }


def write_cell(root, model=None, popularity="zipf", mix="tiny-open"):
    """Write the tiny cell's files (its configuration and its mix ``mix``)
    under ``root`` beside the checkout's metrics, and return (cell name,
    BENCHMARK dict)."""
    (root / "ragbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "ragbench" / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "ragbench" / "configs" / "tiny-gqa.json").write_text(json.dumps(model or MODEL))
    (root / "ragbench" / "traffic" / f"{mix}.json").write_text(json.dumps(traffic(popularity)))
    bench = spec.load()
    bench["configs"].append({"name": "tiny-gqa", "source": MODEL["source"],
                             "file": "ragbench/configs/tiny-gqa.json", "reduced": [],
                             "why": "smoke width"})
    cell = f"tiny-gqa.{mix}"
    bench["workloads"].append({"name": cell, "config": "tiny-gqa", "traffic": mix,
                               "chips": 1, "why": "smoke width on the CPU"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    return cell, bench


def tiny_cell(root, model=None, popularity="zipf"):
    name, bench = write_cell(root, model, popularity)
    return spec.cell(name, bench=bench, root=root)
