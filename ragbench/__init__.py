"""ragbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One run serves one cell of ``BENCHMARK.json``: a model configuration under a
traffic mix. Each request is a vanilla RAG request: documents drawn from a
popularity law, a query embedding that exact search maps back to them,
``VectorIndex.search_exact`` on the card, a ``SegmentedPrompt`` (prelude,
one segment a document, the query) served by the paged ``GenerationEngine``.
Everything that belongs to one configuration, one traffic mix or one metric
is a file of its own, found by the name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``. Nothing here imports JAX or the JAX package, and
the plain reference under ``reference/`` imports nothing of the port.

Run a cell: ``python3 ragbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.
"""
