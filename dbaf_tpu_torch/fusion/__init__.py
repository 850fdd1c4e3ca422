from .preintegration import ImuParams, PreintegratedImu  # noqa: F401
from .graph import (  # noqa: F401
    Values,
    FactorGraph,
    LevenbergMarquardt,
    marginalize_out,
)
