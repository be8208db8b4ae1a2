from .types import (
    MatchingFunction,
    DispDirection,
    ExtractionStrategy,
    TruncatedCvDirection,
    MATCH_TRAITS,
    MatchTraits,
    disp_dtype,
    default_cv_value,
)
from .margins import Margins, PaddingMargins
from .search import SearchOffset1, SearchOffset2
from .utils import (Contiguity, PropagationDirection, IndexPairMap,
                    NumbersCache, accumulation_extended_dtype,
                    equivalent_one_for_normalizing)

__all__ = [
    "MatchingFunction",
    "DispDirection",
    "ExtractionStrategy",
    "TruncatedCvDirection",
    "MATCH_TRAITS",
    "MatchTraits",
    "disp_dtype",
    "default_cv_value",
    "Margins",
    "PaddingMargins",
    "SearchOffset1",
    "SearchOffset2",
    "Contiguity",
    "PropagationDirection",
    "IndexPairMap",
    "NumbersCache",
    "accumulation_extended_dtype",
    "equivalent_one_for_normalizing",
]
