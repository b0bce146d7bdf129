"""MEF object model: the Open-PSA Model Exchange Format semantic layer.

A faithful, Pythonic re-design of the reference MEF layer
(``reference/src/mef/openpsa/``): elements/roles/containers, events and
formulas, the expression system (constants, numerics, booleans, conditionals,
distributions, random deviates, test-events, extern functions), fault trees,
event trees, CCF groups, substitutions, alignments, instructions, and the
root :class:`Model` container — everything the two-phase initializer needs.
"""

from .element import (Attribute, Element, NodeMark, RoleSpecifier,  # noqa: F401
                      Table)
from .event import (BasicEvent, Connective, Event, Formula, Gate,  # noqa: F401
                    HouseEvent, CONNECTIVE_NAMES)
from .expression import Expression, Interval  # noqa: F401
from .parameter import MissionTime, Parameter, Units  # noqa: F401
from .fault_tree import Component, FaultTree  # noqa: F401
from .event_tree import (Branch, EventTree, Fork, FunctionalEvent,  # noqa: F401
                         InitiatingEvent, NamedBranch, Path, Sequence)
from .instruction import (Block, CollectExpression, CollectFormula,  # noqa: F401
                          IfThenElse, Instruction, InstructionVisitor, Link,
                          Rule, SetHouseEvent)
from .ccf_group import (AlphaFactorModel, BetaFactorModel, CcfEvent,  # noqa: F401
                        CcfGroup, MglModel, PhiFactorModel)
from .substitution import Substitution  # noqa: F401
from .alignment import Alignment, Phase  # noqa: F401
from .model import Context, Model  # noqa: F401
from .initializer import Initializer  # noqa: F401
