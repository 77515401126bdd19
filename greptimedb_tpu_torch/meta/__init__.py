from .failure_detector import PhiAccrualFailureDetector
from .instruction import Instruction, InstructionKind
from .metasrv import Metasrv, MetasrvOptions
from .route import RegionRoute, TableRoute

__all__ = [
    "Instruction",
    "InstructionKind",
    "Metasrv",
    "MetasrvOptions",
    "PhiAccrualFailureDetector",
    "RegionRoute",
    "TableRoute",
]
