"""Concrete MEF expression families."""

from .constant import ConstantExpression, ONE, PI, ZERO  # noqa: F401
from .numerical import (Abs, Acos, Add, Asin, Atan, Ceil, Cos, Cosh,  # noqa: F401
                        Div, Exp, Floor, Log, Log10, Max, Mean, Min, Mod, Mul,
                        Neg, Pow, Sin, Sinh, Sqrt, Sub, Tan, Tanh)
from .boolean import And, Df, Eq, Geq, Gt, Leq, Lt, Not, Or  # noqa: F401
from .conditional import Ite, Switch  # noqa: F401
from .exponential import Exponential, Glm, PeriodicTest, Weibull  # noqa: F401
from .random_deviate import (BetaDeviate, GammaDeviate, Histogram,  # noqa: F401
                             LognormalDeviate, NormalDeviate, RandomDeviate,
                             UniformDeviate)
from .test_event import TestFunctionalEvent, TestInitiatingEvent  # noqa: F401
from .extern import ExternExpression, ExternFunction, ExternLibrary  # noqa: F401
