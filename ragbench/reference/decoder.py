"""The plain reference: a frozen GQA decoder in float32, written from the
published description of the Llama-style decoders the cells run (Phi-3,
arXiv:2404.14219 and its model card; Qwen2, arXiv:2407.10671): per layer
``h = x + Wo Attn(RoPE(Wq n(x) + bq), RoPE(Wk n(x) + bk), Wv n(x) + bv)``,
``out = h + W_down(silu(W_gate n(h)) * W_up n(h))`` with ``n`` an RMSNorm
(x / sqrt(mean(x^2) + eps) times a scale), grouped-query attention (each KV
head serves num_heads / num_kv_heads query heads), rotary embeddings that
rotate the two halves of each head, then a final RMSNorm and the head (the
embedding's transpose when tied).

It imports nothing of the port. It works out the segment semantics of a
retrieval-augmented prompt from the segments it is handed: prelude tokens
at position = slot, causal; each document attends the prelude and itself,
its positions restarting after the prelude; the query and the answer attend
everything, at position = slot. Matmuls run in float32 with TF32 off; the
bf16 weights are upcast one layer at a time, and every sequence is carried
through a layer before the next one is upcast.

``linear`` (default ``x @ w``) is the one place a lower precision enters:
the control passes one that rounds both operands (``control.py``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

QUERY_BLOCK = 1024  # query rows of one attention block


@dataclass
class Served:
    """One served request as the benchmark handed it over: the prompt's
    segments and the tokens the program answered."""
    prelude: np.ndarray
    docs: List[np.ndarray]
    query: np.ndarray
    answer: np.ndarray

    def tokens(self) -> np.ndarray:
        """Prompt and every answer token but the last (teacher forcing)."""
        return np.concatenate([self.prelude, *self.docs, self.query, self.answer[:-1]])

    @property
    def prompt_len(self) -> int:
        return len(self.prelude) + sum(len(d) for d in self.docs) + len(self.query)


def layout(s: Served):
    """(positions, p_end, s_start), each (len(tokens),) int64: a token at
    slot t attends the slots u <= t with u < p_end[t] or u >= s_start[t]."""
    n = len(s.tokens())
    pos = np.arange(n, dtype=np.int64)
    p_end = np.zeros(n, np.int64)
    s_start = np.zeros(n, np.int64)
    pe = len(s.prelude)
    start = pe
    for d in s.docs:
        end = start + len(d)
        pos[start:end] = pe + np.arange(len(d))
        p_end[start:end] = pe
        s_start[start:end] = start
        start = end
    return pos, p_end, s_start


@contextlib.contextmanager
def full_float32():
    """float32 matmuls without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (S, heads, hd) rotated by positions pos (S,): the first half of
    each head against the second."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (pos.double()[:, None] * inv[None]).float()
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v, p_end, s_start):
    """q (S, H, hd), k and v (S, KVH, hd), the segment mask's vectors (S,):
    softmax(q k^T / sqrt(hd)) v over the visible slots, in query blocks."""
    S, H, hd = q.shape
    KVH = k.shape[1]
    G = H // KVH
    qg = q.reshape(S, KVH, G, hd).permute(1, 2, 0, 3)          # (KVH, G, S, hd)
    kt = k.permute(1, 2, 0)                                     # (KVH, hd, S)
    vv = v.permute(1, 0, 2)                                     # (KVH, S, hd)
    slots = torch.arange(S, device=q.device)
    out = torch.empty((KVH, G, S, hd), dtype=q.dtype, device=q.device)
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(S, lo + QUERY_BLOCK)
        r = slots[lo:hi, None]
        visible = (slots[None] <= r) & ((slots[None] < p_end[lo:hi, None])
                                        | (slots[None] >= s_start[lo:hi, None]))
        scores = (qg[:, :, lo:hi] @ kt[:, None]) / hd ** 0.5    # (KVH, G, n, S)
        scores = scores.masked_fill(~visible, float("-inf"))
        out[:, :, lo:hi] = torch.softmax(scores, dim=-1) @ vv[:, None]
        del scores
    return out.permute(2, 0, 1, 3).reshape(S, H * hd)


def _layer(m, w, x, pos, p_end, s_start, linear):
    H, KVH, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    S = x.shape[0]
    n = rms_norm(x, w["norm1"], eps)
    q, k, v = linear(n, w["wq"]), linear(n, w["wk"]), linear(n, w["wv"])
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.reshape(S, H, hd), pos, theta)
    k = rope(k.reshape(S, KVH, hd), pos, theta)
    h = x + linear(attention(q, k, v.reshape(S, KVH, hd), p_end, s_start), w["wo"])
    n = rms_norm(h, w["norm2"], eps)
    act = torch.nn.functional.silu(linear(n, w["w_gate"])) * linear(n, w["w_up"])
    return h + linear(act, w["w_down"])


def _layer_weights(blocks, layer: int, device) -> dict:
    """Layer ``layer``'s leaves, upcast to float32."""
    a, mlp = blocks["attn"], blocks["mlp"]
    w = {name: a[name][layer] for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv") if name in a}
    w.update({name: mlp[name][layer] for name in ("w_gate", "w_up", "w_down")})
    w["norm1"], w["norm2"] = blocks["norm1"]["scale"][layer], blocks["norm2"]["scale"][layer]
    return {k: v.to(device=device, dtype=torch.float32) for k, v in w.items()}


def logits(m: dict, weights, served: Sequence[Served], device,
           linear: Optional[Callable] = None) -> List[torch.Tensor]:
    """For each served request, the float32 logits (n_answer, vocab_size) at
    the positions that produced its answer tokens (the prompt's last slot,
    then each answer token but the last)."""
    linear = linear or (lambda x, w: x @ w)
    V = m["vocab_size"]
    table = weights["embed"]["table"]
    with torch.no_grad(), full_float32():
        xs, geo = [], []
        for s in served:
            toks = torch.as_tensor(s.tokens(), dtype=torch.long, device=table.device)
            xs.append(table[toks].to(device=device, dtype=torch.float32))
            geo.append(tuple(torch.as_tensor(a, device=device) for a in layout(s)))
        blocks = weights["blocks"][0]
        for layer in range(m["num_hidden_layers"]):
            w = _layer_weights(blocks, layer, device)
            xs = [_layer(m, w, x, *g, linear) for x, g in zip(xs, geo)]
            del w
        final = weights["final_norm"]["scale"].to(device=device, dtype=torch.float32)
        if m["tie_word_embeddings"]:
            head = table[:V].to(device=device, dtype=torch.float32).T
        else:
            head = weights["lm_head"]["w"][:, :V].to(device=device, dtype=torch.float32)
        out = []
        for x, s in zip(xs, served):
            rows = x[s.prompt_len - 1: s.prompt_len - 1 + len(s.answer)]
            out.append(linear(rms_norm(rows, final, m["rms_norm_eps"]), head))
        return out


def widest_gap(ref: Sequence[torch.Tensor], tokens: Sequence[np.ndarray]) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position (inf for a token outside the
    vocabulary)."""
    worst = 0.0
    for lg, t in zip(ref, tokens):
        t = torch.as_tensor(np.asarray(t, np.int64), device=lg.device)
        if bool(((t < 0) | (t >= lg.shape[1])).any()):
            return float("inf")
        gap = lg.max(dim=1).values - lg.gather(1, t[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst
