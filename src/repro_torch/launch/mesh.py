"""Serving and production meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

The reference's meshes are of devices in one process; the port's are of
ranks, one process per mesh coordinate, each holding its own block of the
sharded state.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the world the caller initialised (gloo on the CPU, NCCL on CUDA: the
backend picks the mesh's device type), so building one never starts a
process: ``launch.preboot`` starts the ranks of a ``--mesh`` CLI run, and
``torchrun`` does it for any other.

Single pod: (data=16, model=16) = 256 ranks; multi-pod: (pod=2, data=16,
model=16) = 512 ranks.
"""

from __future__ import annotations

import math

import torch.distributed as dist


def _mesh(shape, axes, spec: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the whole world,
    which must hold exactly ``prod(shape)`` ranks."""
    need = math.prod(shape)
    if not dist.is_initialized():
        raise ValueError(
            f"mesh {spec} needs a torch.distributed world of {need} ranks "
            f"but none is initialised; launch with torchrun "
            f"--nproc-per-node {need} (or through a CLI's --mesh, which "
            f"starts the ranks itself)")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"mesh {spec} needs {need} ranks but the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16), or (pod=2, data=16, model=16): raises unless
    the world holds exactly that many ranks."""
    sizes = production_shape(multi_pod)
    shape = tuple(sizes.values())
    return _mesh(shape, tuple(sizes), "x".join(map(str, shape)))


def make_host_mesh(model: int = 1):
    """(world // model, model) mesh over the initialised world (tests,
    examples)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = max(n // model, 1)
    return _mesh((data, model), ("data", "model"), f"{data}x{model}")


def parse_mesh_spec(spec: str):
    """'dxm' (e.g. '2x4') → (data, model) ints."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be 'DATAxMODEL' (e.g. 2x4), "
                         f"got {spec!r}")
    data, model = (int(p) for p in parts)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return data, model


def make_serving_mesh(spec: str):
    """(data, model) mesh for the serving engine from a CLI 'dxm' spec:
    decode slots shard over ``data``, attention heads over ``model``
    (runtime/server.py).  The world must already hold data × model ranks
    (``launch.preboot`` or ``torchrun``); the error names that count."""
    data, model = parse_mesh_spec(spec)
    return _mesh((data, model), ("data", "model"), spec)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of a stand-in whose
    ``shape`` is already that dict (the spec tests' fake meshes)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class StandInMesh:
    """A mesh's shape without a world, for one rank of it: ``shape``
    {axis: size} (what :func:`mesh_sizes` reads), ``mesh_dim_names`` and
    ``get_coordinate()`` (this rank's coordinate, every axis 0 unless
    ``coord`` says otherwise).  The dry run counts a rank's step of a
    16 x 16 or 2 x 16 x 16 mesh on the ``meta`` device through one, where
    the rules' collectives move nothing."""

    def __init__(self, shape: dict, coord: dict = None):
        self.shape = dict(shape)
        self.mesh_dim_names = tuple(shape)
        self._coord = dict(coord or {})

    def get_coordinate(self):
        return [self._coord.get(a, 0) for a in self.mesh_dim_names]


def production_shape(multi_pod: bool) -> dict:
    """{axis: size} of the production mesh: (data=16, model=16), or
    (pod=2, data=16, model=16)."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
