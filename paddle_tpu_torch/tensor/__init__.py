"""paddle.tensor namespace of the port (port of ``paddle_tpu/tensor``):
the op-dispatch wrappers of ``ops/api.py`` in the reference's module
layout (math, linalg, manipulation, creation, logic, random, search,
stat, attribute), plus the search, stat and random functions the flat
namespace lacks. Every function works in dygraph (Tensor in and out) and
static (Variable in and out) mode through the same dispatch; one whose
op the port does not lower yet raises the registry's ``Unimplemented``
(ROADMAP queue A, item A11)."""
from . import attribute, creation, linalg, logic, manipulation, math, random, search, stat
from .attribute import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
