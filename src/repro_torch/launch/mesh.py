"""Device meshes over the running process group (the JAX package's
``repro.launch.mesh``).

SPMD: one process per device, started by ``torchrun --nproc-per-node N``
(or by the tests' spawned gloo world) and joined in a process group with
``torch.distributed.init_process_group`` BEFORE a mesh is made.  The mesh
covers every rank of that group, row-major.  Its device type is that of
the tensors the ranks compute on: ``"cuda"`` by default (NCCL, or gloo
when several ranks share one card), ``"cpu"`` under gloo in the tests.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def _world(fn: str, need: int) -> None:
    import torch.distributed as dist
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have == need:
        return
    why = (f"the process group has {have} ranks" if have
           else "no process group is initialised")
    raise RuntimeError(
        f"{fn} needs {need} ranks but {why}.  Start one process per rank "
        f"with `torchrun --nproc-per-node {need}` (tests: the spawned gloo "
        "world of tests/torch_world.py), and call "
        "torch.distributed.init_process_group in every rank before making "
        "the mesh.")


def _mesh(shape, axes, device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's 16x16 TPU pod (and 2-pod 2x16x16) layouts have no
    counterpart on H100 cards: raises."""
    raise NotImplementedError(
        f"make_production_mesh(multi_pod={multi_pod}): the TPU pod layouts "
        "(16x16 chips, 2 pods) have no H100 counterpart; build a mesh over "
        "the ranks you started with make_debug_mesh or make_lane_mesh")


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device_type: Optional[str] = None):
    """A ("data", "model") mesh of n_data x n_model ranks.  Checks the
    world size eagerly and names how to get enough ranks."""
    _world(f"make_debug_mesh({n_data}, {n_model})", n_data * n_model)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def make_lane_mesh(shape: Sequence[int], axes=None, *,
                   device_type: Optional[str] = None):
    """Data-axes-only mesh for ``solve(mesh=...)`` lane sharding.  Axis
    names default to ``("data",)`` for 1-d shapes and ``("pod", "data")``
    for 2-d (the axes ``repro_torch.parallel`` shards lanes over).  Same
    eager world-size check as ``make_debug_mesh``."""
    shape = tuple(shape)
    if axes is None:
        axes = {1: ("data",), 2: ("pod", "data")}.get(len(shape))
        if axes is None:
            raise ValueError(
                f"make_lane_mesh: pass axes= for a {len(shape)}-d shape "
                "(defaults exist for 1-d and 2-d only)")
    _world(f"make_lane_mesh({shape})", math.prod(shape))
    return _mesh(shape, axes, device_type)
