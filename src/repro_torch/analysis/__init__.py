"""repro_torch.analysis: the KV lifecycle sanitizer of the port.

``kvsan`` is a shadow-state sanitizer for the three-tier KV block lifecycle
(device pool, warm LRU, host tier, with the copy engine between them),
enabled by ``PagedKVCache(sanitize=True)`` / ``GenerationEngine(sanitize=
True)``. ``python -m repro_torch.analysis kvsan`` runs a clean lifecycle
under the shadow (exit 0) or, with ``--mutate <id>``, seeds one known
defect that the sanitizer must catch (exit 1).
"""
from repro_torch.analysis.kvsan import KVSanError, KVSanitizer

__all__ = ["KVSanError", "KVSanitizer"]
