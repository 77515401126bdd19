from .procedure import (
    FnStepProcedure,
    Procedure,
    ProcedureManager,
    ProcedureRecord,
    ProcedureStore,
    Status,
)

__all__ = [
    "FnStepProcedure",
    "Procedure",
    "ProcedureManager",
    "ProcedureRecord",
    "ProcedureStore",
    "Status",
]
