from repro_torch.apps.rag_apps import (
    EnginePipeline,
    OpenLoopDriver,
    RAGApp,
    VirtualClock,
    WallClock,
    make_adaptive_rag,
    make_app,
    make_corrective_rag,
    make_graph_rag,
    make_plan_rag,
    make_self_rag,
    make_vanilla_rag,
)

APPS = {
    "vrag": make_vanilla_rag,
    "crag": make_corrective_rag,
    "srag": make_self_rag,
    "arag": make_adaptive_rag,
    "graphrag": make_graph_rag,
    "planrag": make_plan_rag,
}

__all__ = ["APPS", "RAGApp", "make_app", "make_vanilla_rag", "make_corrective_rag",
           "make_self_rag", "make_adaptive_rag", "make_graph_rag", "make_plan_rag",
           "EnginePipeline", "OpenLoopDriver", "VirtualClock", "WallClock"]
