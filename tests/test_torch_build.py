"""How the port's CUDA libraries are keyed: ``_build.source_digest`` covers
a source, every header beside it and the compiler flags, so an edit to a
shared header rebuilds the libraries instead of loading stale ones. Runs on
the CPU (no compiler is called)."""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc_copy(tmp_path):
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_digest_follows_the_sources_and_headers(csrc_copy, name):
    source = csrc_copy / f"{name}.cu"
    before = _build.source_digest(source)
    # the same bytes elsewhere: the same library
    assert before == _build.source_digest(_build.SOURCES[name])
    headers = sorted(csrc_copy.glob("*.cuh"))
    assert headers, "csrc/ holds the shared attention header"
    for header in headers:
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = _build.source_digest(source)
        assert after != before
        before = after
    (csrc_copy / "new_header.cuh").write_text("#pragma once\n")
    assert _build.source_digest(source) != before
    before = _build.source_digest(source)
    source.write_bytes(source.read_bytes() + b"\n")
    assert _build.source_digest(source) != before


def test_attention_sources_share_the_header():
    for name in ("dense_attention", "paged_attention"):
        assert '#include "attention_common.cuh"' in _build.SOURCES[name].read_text()


def test_scan_sources_share_the_header():
    for name in ("rwkv6_scan", "ssm_scan"):
        assert '#include "scan_common.cuh"' in _build.SOURCES[name].read_text()


def test_split_tf32_sources_share_the_header():
    """The WKV and top-k kernels take their split-tf32 helpers from one
    header; neither keeps a copy of its own."""
    for name in ("rwkv6_scan", "topk_retrieval"):
        text = _build.SOURCES[name].read_text()
        assert '#include "tf32_mma.cuh"' in text
        assert "cvt.rna.tf32.f32" not in text and "uint32_t to_tf32(" not in text
