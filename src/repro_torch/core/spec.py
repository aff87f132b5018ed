"""Patchwork specification layer: the ``@patchwork.make`` decorator.

Developers write RAG pipelines in idiomatic Python; decorating a component
class registers it with the framework and attaches declarative constraints:

    @make(base_instances=2, stateful=True, resources={"GPU": 1, "CPU": 4})
    class Grader(Generator):
        def grade(self, docs): ...

Unlike Ray's detached actors, every decorated class is a fully managed
long-running distributed actor: launch, placement, replication and routing
are owned by the framework (components are stateful with significant
cold-start cost, so the runtime may never kill-and-respawn them casually).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# component metadata & registry
# ---------------------------------------------------------------------------


@dataclass
class ComponentMeta:
    name: str
    base_instances: int = 1
    stateful: bool = False
    resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 1})
    max_instances: int = 64
    startup_cost_s: float = 2.0          # cold-start penalty on scale-up
    # profiling results (filled by core.profiling)
    alpha: Dict[str, float] = field(default_factory=dict)   # req/s per resource unit
    alpha_hit_rate: Optional[float] = None  # prefix hit rate baked into alpha
    alpha_host_hit_rate: Optional[float] = None  # host-tier rate baked into alpha
    gamma: float = 1.0                                       # request amplification
    streaming: bool = False

    def dominant_resource(self) -> str:
        # priority-ordered: the scarce accelerator dominates regardless of
        # unit counts (1 GPU outranks 8 CPUs outranks 112 GB RAM)
        for r in ("GPU", "CPU", "RAM"):
            if self.resources.get(r, 0) > 0:
                return r
        return max(self.resources, key=lambda k: self.resources[k])


class ComponentRegistry:
    """Process-wide registry of decorated component classes/instances."""

    def __init__(self):
        self._lock = threading.Lock()
        self.classes: Dict[str, type] = {}
        self.instances: Dict[str, "object"] = {}

    def register_class(self, cls, meta: ComponentMeta):
        with self._lock:
            self.classes[meta.name] = cls

    def register_instance(self, name: str, obj):
        with self._lock:
            self.instances[name] = obj

    def clear(self):
        with self._lock:
            self.classes.clear()
            self.instances.clear()


REGISTRY = ComponentRegistry()


def make(
    _cls=None,
    *,
    base_instances: int = 1,
    stateful: bool = False,
    resources: Optional[Dict[str, float]] = None,
    max_instances: int = 64,
    startup_cost_s: float = 2.0,
    streaming: bool = False,
):
    """Decorator (or wrapper for instances) that registers a RAG component.

    Mirrors the paper's ``@harmonia.make``: the developer supplies coarse
    hints (base instances, resource needs, statefulness); the deployment and
    runtime layers own everything else.
    """

    def wrap(cls_or_obj):
        if isinstance(cls_or_obj, type):
            meta = ComponentMeta(
                name=cls_or_obj.__name__,
                base_instances=base_instances,
                stateful=stateful,
                resources=dict(resources or {"CPU": 1}),
                max_instances=max_instances,
                startup_cost_s=startup_cost_s,
                streaming=streaming,
            )
            cls_or_obj.__patchwork_meta__ = meta
            REGISTRY.register_class(cls_or_obj, meta)
            return cls_or_obj
        # instance form: patchwork.make(WebSearch(...))
        obj = cls_or_obj
        meta = ComponentMeta(
            name=type(obj).__name__,
            base_instances=base_instances,
            stateful=stateful,
            resources=dict(resources or {"CPU": 1}),
            max_instances=max_instances,
            startup_cost_s=startup_cost_s,
            streaming=streaming,
        )
        obj.__patchwork_meta__ = meta
        REGISTRY.register_instance(meta.name, obj)
        return obj

    if _cls is not None:
        return wrap(_cls)
    return wrap


def meta_of(obj) -> Optional[ComponentMeta]:
    return getattr(obj, "__patchwork_meta__", None) or getattr(
        type(obj), "__patchwork_meta__", None
    )
