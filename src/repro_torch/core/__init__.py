"""Core solver library: tableaus, stage combines, steppers, the symplectic
adjoint, and the ``solve`` API."""
from .api import (GRADIENT_REGISTRY, NOT_PORTED, DirectBackprop,
                  GradientStrategy, SaveAt, Solution, SymplecticAdjoint,
                  as_gradient, capability_matrix, register_gradient, solve)
from .combine import COMBINE_BACKENDS, StageCombiner, get_combiner
from .rk import (AdaptiveConfig, AdaptiveSolution, FixedSolution,
                 apply_on_failure, rk_solve_adaptive, rk_solve_fixed,
                 rk_stages, rk_step)
from .stepper import AdaptiveStepper, FixedStepper, SolverState
from .symplectic import (odeint_symplectic, odeint_symplectic_adaptive,
                         symplectic_step_adjoint)
from .tableau import HERMITE_DENSE_W, TABLEAUS, ButcherTableau, get_tableau

__all__ = [
    "AdaptiveConfig", "AdaptiveSolution", "AdaptiveStepper",
    "ButcherTableau", "COMBINE_BACKENDS", "DirectBackprop", "FixedSolution",
    "FixedStepper", "GRADIENT_REGISTRY", "GradientStrategy",
    "HERMITE_DENSE_W", "NOT_PORTED", "SaveAt", "Solution", "SolverState",
    "StageCombiner", "SymplecticAdjoint", "TABLEAUS", "apply_on_failure",
    "as_gradient", "capability_matrix", "get_combiner", "get_tableau",
    "odeint_symplectic", "odeint_symplectic_adaptive", "register_gradient",
    "rk_solve_adaptive", "rk_solve_fixed", "rk_stages", "rk_step", "solve",
    "symplectic_step_adjoint",
]
