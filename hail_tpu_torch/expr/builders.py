"""Case/switch expression builders (reference hail/expr/builders.py).
The builder objects themselves are constructed by hl.case()/hl.switch() in
functions.py; this module re-exports them under the reference module path.
"""

from .functions import case, switch

try:
    from .functions import _CaseBuilder as CaseBuilder
except ImportError:
    CaseBuilder = type(case())
try:
    from .functions import _SwitchBuilder as SwitchBuilder
except ImportError:
    SwitchBuilder = None

__all__ = ['case', 'switch', 'CaseBuilder', 'SwitchBuilder']
