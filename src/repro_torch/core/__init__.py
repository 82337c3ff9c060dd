"""Core solver library: tableaus, stage combines, steppers, the symplectic
adjoint, the paper's baseline gradient strategies, and the ``solve`` API."""
from .adjoint import (odeint_adjoint, odeint_adjoint_adaptive,
                      odeint_adjoint_adaptive_batched)
from .api import (GRADIENT_REGISTRY, ContinuousAdjoint,
                  DirectBackprop, GradientStrategy, RematSolve, RematStep,
                  SaveAt, Solution, SymplecticAdjoint, as_gradient,
                  batched_capability_matrix, capability_matrix,
                  mesh_capability_matrix, register_gradient, solve)
from .backprop import odeint_backprop, odeint_remat_solve, odeint_remat_step
from .combine import COMBINE_BACKENDS, StageCombiner, get_combiner
from .odeint import GRAD_MODES, TS_MODES, odeint, odeint_with_stats
from .rk import (AdaptiveConfig, AdaptiveSolution, BatchedAdaptiveSolution,
                 FixedSolution, apply_on_failure, apply_on_failure_lanes,
                 hermite_observe, lane_count, rk_solve_adaptive,
                 rk_solve_adaptive_batched,
                 rk_solve_adaptive_batched_saveat_stacked,
                 rk_solve_adaptive_saveat_stacked,
                 rk_solve_fixed, rk_stages, rk_step, segment_starts)
from .stepper import (AdaptiveStepper, BatchedSolverState, FixedStepper,
                      SolverState)
from .symplectic import (odeint_symplectic, odeint_symplectic_adaptive,
                         odeint_symplectic_adaptive_batched,
                         odeint_symplectic_saveat,
                         odeint_symplectic_saveat_adaptive,
                         odeint_symplectic_saveat_adaptive_batched,
                         symplectic_step_adjoint,
                         symplectic_step_adjoint_lanes)
from .tableau import HERMITE_DENSE_W, TABLEAUS, ButcherTableau, get_tableau

__all__ = [
    "AdaptiveConfig", "AdaptiveSolution", "AdaptiveStepper",
    "BatchedAdaptiveSolution", "BatchedSolverState", "ButcherTableau",
    "COMBINE_BACKENDS", "ContinuousAdjoint", "DirectBackprop", "FixedSolution", "FixedStepper",
    "GRADIENT_REGISTRY", "GRAD_MODES", "GradientStrategy", "HERMITE_DENSE_W",
    "RematSolve", "RematStep", "SaveAt", "Solution", "SolverState", "StageCombiner",
    "SymplecticAdjoint", "TABLEAUS", "apply_on_failure",
    "apply_on_failure_lanes", "as_gradient", "batched_capability_matrix",
    "capability_matrix", "mesh_capability_matrix", "get_combiner", "get_tableau", "hermite_observe",
    "lane_count", "odeint", "odeint_with_stats",
    "odeint_adjoint", "odeint_adjoint_adaptive",
    "odeint_adjoint_adaptive_batched", "odeint_backprop",
    "odeint_remat_solve", "odeint_remat_step", "odeint_symplectic", "odeint_symplectic_adaptive",
    "odeint_symplectic_adaptive_batched", "odeint_symplectic_saveat",
    "odeint_symplectic_saveat_adaptive",
    "odeint_symplectic_saveat_adaptive_batched", "register_gradient",
    "rk_solve_adaptive", "rk_solve_adaptive_batched",
    "rk_solve_adaptive_batched_saveat_stacked",
    "rk_solve_adaptive_saveat_stacked", "rk_solve_fixed", "rk_stages",
    "rk_step", "segment_starts", "solve", "symplectic_step_adjoint",
    "symplectic_step_adjoint_lanes", "TS_MODES",
]
