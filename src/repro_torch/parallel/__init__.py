"""Multi-device execution over ``torch.distributed``, SPMD: one process per
device, each running the same program on its own block (the JAX package's
``repro.parallel``, which runs single-controller under ``shard_map``).

* ``solve``: lane-sharded solving (``core.solve(..., mesh=)``), its specs
  and load metrics;
* ``mesh_rules`` / ``shardings``: the logical-axis rules and the spec
  layer for params, optimizer state (ZeRO-1), batches and caches;
* ``layout``: specs, placements, process groups over mesh axes;
* ``comm``: the one wrapper every collective goes through (counted), and
  the differentiable regions of tensor parallelism;
* ``tensor``: tensor parallelism over "model" (the eager counterpart of
  the logical rules: column / row blocks, ``seq_carry``, vocab-parallel
  lookup and loss).

``__all__`` is the JAX package's, plus ``PartitionSpec`` / ``P`` (JAX has
its own), ``Owned`` (a unit's optimizer leaf held whole, the per-unit form
of ZeRO-1 on a stacked dim), ``placements`` and ``gather``, minus
``lift_scalar_params``: it works around jax 0.4.37's ``shard_map``
transpose of rank-0 inputs, and a rank-0 leaf crosses the port's solve
boundary as it is (its gradient comes back rank-0 and exact: the mesh
tests' scalar-leaf case).
"""
from .layout import P, PartitionSpec, gather, lane_spec, placements
from .mesh_rules import LOGICAL_RULES, make_sharder
from .shardings import Owned, batch_specs, cache_specs, param_specs, \
    state_specs
from .solve import (DATA_AXES, batched_solution_specs, lane_axes,
                    resolve_param_specs, shard_count, sharded_solve_triple,
                    solver_state_specs, with_shard_load_stats)

__all__ = ["LOGICAL_RULES", "make_sharder", "param_specs", "state_specs",
           "batch_specs", "cache_specs", "DATA_AXES", "lane_axes",
           "lane_spec", "shard_count",
           "batched_solution_specs", "solver_state_specs",
           "resolve_param_specs", "sharded_solve_triple",
           "with_shard_load_stats", "P", "PartitionSpec", "Owned",
           "placements", "gather"]
