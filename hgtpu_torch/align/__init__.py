from .types import ReadAln
from .aligner import GeneAligner
from .panel import PanelRouter
from .family import FamilyAligner
from .linear import LinearAligner
