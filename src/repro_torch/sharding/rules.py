"""Logical-axis sharding rules, divisibility-aware (port of
``repro.sharding.rules``).

A rules object maps logical axis names ("batch", "heads", "kv_heads", …)
to mesh axes, and a *spec* says, for each dimension of a tensor, the mesh
axes that partition it: a tuple with one entry per dimension, None or a
tuple of axis names (the port's ``PartitionSpec``; ``()`` replicates
everything).  A dimension is sharded only when its size divides evenly;
otherwise it is replicated (never crash: small models on big meshes
degrade to partial parallelism).

The specs are the reference's.  What the reference does with them differs:
its ``device_put`` places a global array on a mesh, while every rank of the
port is a process that holds only its own block.  So ``shard_cache``,
``place_admission``, ``place_block_tables``, ``place_prefix_snapshot`` and
``place_swap_payload`` take this rank's block of a whole tensor (its
coordinate along each sharded dimension's axes), and nothing is ever
gathered back but through an explicit collective (``kernels.ops``'s head
island, the server's token gather, the MoE dispatch's exchanges).
Parameters replicate at serve time, as in the reference, but for the MoE
routed-expert banks: ``serving_param_specs`` distributes those, and
``place_serving_params`` keeps this rank's block of them
(``models/moe.py`` exchanges the rows the other experts need).

Training places every parameter and both AdamW moments by
``tree_param_specs`` (``place_train_state``).  The step gathers each leaf
whole through :class:`GatherLeaf`, an autograd function whose backward
sums the gradient over the axes the step's rows are split on and keeps
this rank's block: the model axis shards storage, and compute is split
over rows only.  Every collective of the training step goes through this
module's three primitives (:func:`all_gather_dim`,
:func:`reduce_scatter_dim`, :func:`all_reduce`); on the ``meta`` device
they move nothing and return tensors of the right shape, and under a
``roofline.op_count.OpCounter`` each records its kind and bytes, so the
dry run counts a rank's collectives with no world.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.roofline import op_count


def P(*dims):
    """A partition spec: one entry a dimension, None or axis names."""
    return tuple(dims)


@dataclasses.dataclass
class Rules:
    mesh: object                     # DeviceMesh (or a stand-in with .shape)
    table: dict                      # logical axis -> mesh axis tuple | None
    fsdp: bool = False               # shard params/opt-state over data axis
    # every rank holds all rows of the step (a B=1 admission prefill,
    # ``admission_spec``) instead of its ``batch`` shard's
    whole_rows: bool = False
    # a training step's rules: the mesh axes its rows are split over (()
    # when every rank holds all rows); the parameters are whole on every
    # rank (``GatherLeaf``).  None: serving
    train_rows: Optional[tuple] = None

    def size(self, axes) -> int:
        """Ranks along mesh axes ``axes`` (a name or a tuple of names)."""
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in _axes(axes))

    def axes_for(self, logical: Optional[str], dim: int):
        if logical is None:
            return None
        axes = self.table.get(logical)
        if not axes:
            return None
        total = self.size(axes)
        if dim % total != 0:
            # try a prefix of the axes (e.g. batch over ("pod","data") but
            # dim only divisible by pod count)
            for cut in range(len(axes) - 1, 0, -1):
                sub = axes[:cut]
                if dim % self.size(sub) == 0:
                    return tuple(sub)
            return None
        return tuple(axes)

    def axis_index(self, axes) -> int:
        """This rank's index along mesh axes ``axes``, folded row-major
        (the reference's ``_fold_axis_index``)."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        sizes = mesh_sizes(self.mesh)
        idx = 0
        for a in _axes(axes):
            idx = idx * sizes[a] + coord[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that differ only along ``axes``
        (one mesh axis: the serving mesh's "data" or "model")."""
        axes = _axes(axes)
        if len(axes) != 1:
            raise ValueError(f"no process group over several mesh axes "
                             f"{axes}: a serving mesh is (data, model)")
        return self.mesh.get_group(axes[0])

    def world(self) -> int:
        """Ranks of the whole mesh."""
        return math.prod(mesh_sizes(self.mesh).values())


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(rules: Rules):
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def current_rules() -> Optional[Rules]:
    return _ACTIVE[-1] if _ACTIVE else None


# ---------------------------------------------------------------------------
# Mesh-axis tables
# ---------------------------------------------------------------------------


def default_table(multi_pod: bool, *, seq_shard: bool = False) -> dict:
    batch = ("pod", "data") if multi_pod else ("data",)
    model = ("model",)
    return {
        "batch": batch,
        "seq": None,
        "kvseq": batch if seq_shard else None,  # sequence-parallel KV (SP)
        "d_model": None,
        "heads": model,
        "kv_heads": model,
        "ff": model,
        "vocab": model,
        # full expert parallelism over model×data when the count divides;
        # axes_for falls back to ("model",), then replication
        "experts": ("model", "data"),
        "expert_ff": model,
        "expert_cap": batch,
        "lru": model,
        "ssm_heads": model,
        "state": None,
        "head_dim": None,
    }


# ---------------------------------------------------------------------------
# Parameter partition specs (name-based)
# ---------------------------------------------------------------------------

# rule: regex on the leaf path -> logical axes for the TRAILING dims
_PARAM_RULES = [
    # MoE expert banks: (E, d, f) / (E, f, d)
    (re.compile(r"moe/(w_gate|w_up)$"), ("experts", "fsdp", "expert_ff")),
    (re.compile(r"moe/w_down$"), ("experts", "expert_ff", "fsdp")),
    (re.compile(r"moe/router$"), (None, None)),
    (re.compile(r"moe/bias$"), (None,)),
    # embeddings / heads
    (re.compile(r"embed/table$"), ("vocab", "fsdp")),
    (re.compile(r"embed/head$"), ("fsdp", "vocab")),
    # attention projections
    (re.compile(r"(wq|wk|wv|wuq|wukv)$"), ("fsdp", "model_out")),
    (re.compile(r"(wdq|wdkv|wkr)$"), ("fsdp", None)),
    (re.compile(r"wo$"), ("model_out", "fsdp")),
    # mlp
    (re.compile(r"(w_gate|w_up)$"), ("fsdp", "ff")),
    (re.compile(r"w_down$"), ("ff", "fsdp")),
    # recurrent / ssm
    (re.compile(r"(wx|wg|wa_gate|wi_gate)$"), ("fsdp", "lru")),
    (re.compile(r"rg_out$"), ("lru", "fsdp")),
    (re.compile(r"in_proj$"), ("fsdp", "ssm_ch")),
    (re.compile(r"out_proj$"), ("ssm_ch", "fsdp")),
    (re.compile(r"frontend/proj$"), (None, "fsdp")),
]


def _dedupe(entries) -> list:
    """A mesh axis may appear at most once in a spec: later claims of an
    axis already used replicate."""
    used: set = set()
    out = []
    for ax in entries:
        tup = _axes(ax) if ax is not None else ()
        if not tup or any(a in used for a in tup):
            out.append(None)
        else:
            used.update(tup)
            out.append(ax)
    return out


def param_spec(path: str, shape: Sequence[int], rules: Rules):
    """Partition spec for parameter leaf ``path`` with ``shape``.

    Trailing dims follow the matched rule; extra leading dims are
    unsharded.  ``fsdp`` resolves to the data axis when the rules enable
    it, else replicated; ``model_out`` / ``ff`` etc. resolve to the model
    axis when divisible."""
    logical = None
    for rx, ax in _PARAM_RULES:
        if rx.search(path):
            logical = ax
            break
    if logical is None:
        return P()  # norms, biases, conv kernels, A_log… replicated
    sizes = mesh_sizes(rules.mesh)

    def resolve(name, dim):
        if name is None:
            return None
        if name == "fsdp":
            if not rules.fsdp:
                return None
            # the data axis only: pods replicate params, cross-pod traffic
            # goes through gradient compression
            axes = tuple(a for a in (rules.table.get("batch") or ())
                         if a == "data")
            return axes if axes and dim % rules.size(axes) == 0 else None
        if name == "experts":
            return rules.axes_for("experts", dim)
        if name in ("model_out", "ff", "expert_ff", "vocab", "lru",
                    "ssm_ch", "heads"):
            return ("model",) if dim % sizes["model"] == 0 else None
        axes = rules.table.get(name)
        if not axes:
            return None
        return tuple(axes) if dim % rules.size(axes) == 0 else None

    trailing = [resolve(n, d) for n, d in zip(logical, shape[-len(logical):])]
    return P(*([None] * (len(shape) - len(logical)) + _dedupe(trailing)))


# ---------------------------------------------------------------------------
# Serving-cache partition specs (name-based, like params)
# ---------------------------------------------------------------------------

# KV-cache leaf name -> head-axis position counted from the END of the shape
_CACHE_HEAD_AXIS = {
    "k": 2, "v": 2,                                   # (…, S, H, Dh)
    "k_cents": 2, "v_cents": 2,                       # (…, C, H, Dh)
    "k_tail": 2, "v_tail": 2,                         # (…, R, H, Dh)
    "counts": 1,                                      # (…, C, H)
}


def cache_spec(path: str, shape: Sequence[int], rules: Rules):
    """Partition spec for one serving-cache leaf: decode slots (axis 0,
    or axis 1 under the reference's scan-stacked layer dim) over the
    rules' ``batch`` axes, kv heads over ``model``; a dim that does not
    divide replicates.  Non-KV state gets slot sharding only.  A paged
    tail pool ``(n_blocks, block_size, H, Dh)`` shards its block axis over
    ``batch`` like the slots it backs: the pool is sized shards ×
    pool_blocks and the allocator hands each shard's slots only its own
    block-id range (runtime/kv_pool.py)."""
    parts = path.split("/")
    name = parts[-1]
    stacked = parts[0] == "scan"
    dims: list = [None] * len(shape)
    used: set = set()

    def put(axis_pos: int, logical: str):
        if not 0 <= axis_pos < len(shape):
            return
        res = rules.axes_for(logical, shape[axis_pos])
        tup = _axes(res) if res else ()
        if tup and not any(a in used for a in tup):
            used.update(tup)
            dims[axis_pos] = res

    if name in ("k_scale", "v_scale"):                # (…, H) — no slot dim
        put(len(shape) - 1, "kv_heads")
        return P(*dims)
    put(1 if stacked else 0, "batch")
    head_off = _CACHE_HEAD_AXIS.get(name)
    if head_off is not None and len(shape) - head_off > (1 if stacked else 0):
        put(len(shape) - head_off, "kv_heads")
    return P(*dims)


def block_table_spec(shape: Sequence[int], rules: Rules):
    """Partition spec for the paged engine's block table ``(slots, T)``:
    rows follow the slots over ``batch``, columns replicated."""
    dims: list = [None] * len(shape)
    res = rules.axes_for("batch", shape[0])
    if res:
        dims[0] = res
    return P(*dims)


def admission_spec(path: str, shape: Sequence[int], rules: Rules):
    """Partition spec for a B=1 admission-prefill cache leaf: its slot dim
    cannot shard, its kv-head dims shard over ``model`` like the engine
    cache's."""
    name = path.split("/")[-1]
    dims: list = [None] * len(shape)
    head_off = _CACHE_HEAD_AXIS.get(name)
    if name in ("k_scale", "v_scale"):
        head_off = 1
    if head_off is not None and len(shape) >= head_off:
        res = rules.axes_for("kv_heads", shape[len(shape) - head_off])
        if res:
            dims[len(shape) - head_off] = res
    return P(*dims)


# ---------------------------------------------------------------------------
# This rank's blocks
# ---------------------------------------------------------------------------


def take_block(x: torch.Tensor, spec, rules: Rules) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``: each
    sharded dimension cut into equal parts, the part at this rank's index
    along its axes.  A cut tensor is copied (the whole one can be freed);
    an uncut one (no sharded dimension, or only one-rank axes) is returned
    as is."""
    cut = False
    for dim, axes in enumerate(spec):
        if not axes or rules.size(axes) == 1:
            continue
        n = x.shape[dim] // rules.size(axes)
        x = x.narrow(dim, rules.axis_index(axes) * n, n)
        cut = True
    return x.clone() if cut else x


def _place(tree, rules: Rules, spec_of, path: str = ""):
    """``take_block`` over a tree of tensors (dicts, lists, None leaves),
    each leaf's spec from ``spec_of(path, shape, rules)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _place(v, rules, spec_of, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place(v, rules, spec_of, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return take_block(tree, spec_of(path, tuple(tree.shape), rules), rules)


def shard_cache(cache, rules: Rules):
    """This rank's block of a whole serving cache (engine init): its data
    shard's slots (and pool blocks), its model shard's kv heads."""
    return _place(cache, rules, cache_spec)


def place_admission(cache, rules: Rules):
    """This rank's block of a B=1 admission-prefill cache: its model
    shard's kv heads, every position (``admission_spec``)."""
    return _place(cache, rules, admission_spec)


def place_prefix_snapshot(snap, rules: Rules):
    """This rank's block of a whole prefix-cache snapshot (one slot's
    clustered summary rows): kv heads over ``model``, as
    ``admission_spec``.  The mesh server never needs it: a rank snapshots
    its own rows, already its head block, and an adoption never leaves
    the data shard that registered the entry."""
    return _place(snap, rules, admission_spec)


def place_swap_payload(payload, rules: Rules):
    """This rank's block of a whole swapped-out slot's host payload
    (snapshot and tail blocks): kv heads over ``model``, as
    ``admission_spec``.  The mesh server's payloads are never whole: the
    ranks of the data shard that swapped a slot out gather their own head
    block of it from their cache, and a resume on another data shard
    receives those bytes from the rank of the same model index
    (``move_payload``)."""
    return _place(payload, rules, admission_spec)


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def _refill(tree, it):
    if isinstance(tree, dict):
        return {k: _refill(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, it) for v in tree)
    return None if tree is None else next(it)


def move_payload(payload, group, src: int, dst: int, device):
    """Send a host payload (a tree of CPU tensors) from the rank at index
    ``src`` of ``group`` to the one at ``dst``, point to point, as one
    buffer of its bytes staged on ``device`` (NCCL sends device memory,
    gloo host memory).  On ``src`` the payload is sent and returned as
    is; on ``dst`` it is the buffer of the right shapes and dtypes (its
    contents are not read) and comes back holding ``src``'s bytes; any
    other rank returns it untouched.  The mesh server moves a swapped-out
    slot's payload (snapshot and tail blocks) this way when the slot
    resumes on another data shard: ``group`` is the data group, whose
    index is the data shard's."""
    rank = dist.get_rank(group)
    if rank not in (src, dst) or src == dst:
        return payload
    leaves = _leaves(payload, [])
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in leaves]
    buf = torch.cat(flat).to(device)
    if rank == src:
        dist.send(buf, dst=dist.get_global_rank(group, dst), group=group)
        return payload
    dist.recv(buf, src=dist.get_global_rank(group, src), group=group)
    buf = buf.cpu()
    got, off = [], 0
    for t, f in zip(leaves, flat):
        n = f.numel()
        got.append(buf[off:off + n].clone().view(t.dtype).reshape(t.shape))
        off += n
    return _refill(payload, iter(got))


def place_block_tables(bt, rules: Rules, local_blocks: int = 0):
    """This rank's rows of the paged engine's block table ``(slots, T)``
    (``block_table_spec``), its global block ids rebased to the rank's
    pool block (``local_blocks`` blocks a data shard: the ids of data
    shard s start at s * local_blocks).  The reference rebases inside its
    shard_map island; the port's rank holds only its shard's pool, so the
    ids are rebased on the host before upload.  ``bt`` a numpy array or a
    tensor."""
    spec = block_table_spec(tuple(bt.shape), rules)
    if not spec[0]:
        return bt
    n = bt.shape[0] // rules.size(spec[0])
    s = rules.axis_index(spec[0])
    return bt[s * n:(s + 1) * n] - s * local_blocks


# ---------------------------------------------------------------------------
# Parameter spec trees
# ---------------------------------------------------------------------------


def _spec_tree(params, rules: Rules, spec_of, path: str = ""):
    if isinstance(params, dict):
        return {k: _spec_tree(v, rules, spec_of, f"{path}/{k}" if path else k)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_spec_tree(v, rules, spec_of,
                           f"{path}/{i}" if path else str(i))
                for i, v in enumerate(params)]
    return spec_of(path, tuple(params.shape), rules)


def tree_param_specs(params, rules: Rules):
    """Partition spec tree for a parameter tree (path-aware)."""
    return _spec_tree(params, rules, param_spec)


# serve-time placement: only the leaves whose replication cost dominates
# are distributed; everything else replicates
_SERVING_DISTRIBUTED = re.compile(r"moe/(w_gate|w_up|w_down)$")


def is_expert_bank(path: str) -> bool:
    """Whether parameter leaf ``path`` is a routed-expert bank, the one
    family of leaves mesh serving distributes."""
    return _SERVING_DISTRIBUTED.search(path) is not None


def _serving_spec(path: str, shape, rules: Rules):
    return param_spec(path, shape, rules) if is_expert_bank(path) else P()


def serving_param_specs(params, rules: Rules):
    """Partition spec tree for serve-time parameter placement: MoE routed
    expert banks by ``param_spec`` (the expert dim on ``model``, spilling
    onto ``data`` when the count divides), every other leaf replicated."""
    return _spec_tree(params, rules, _serving_spec)


def place_serving_params(params, rules: Rules):
    """This rank's parameter tree for mesh serving
    (``serving_param_specs``): its block of every MoE routed-expert bank
    (``moe/w_gate``, ``moe/w_up``, ``moe/w_down``), every other leaf (the
    shared expert, the router, its bias) whole."""
    return _place(params, rules, _serving_spec)


def expert_axes(rules: Rules, n_routed: int):
    """The mesh axes the routed-expert dim of ``n_routed`` experts shards
    over at serve time (``("model", "data")`` when the count divides,
    else ``("model",)``, else None: replicated), as ``param_spec`` places
    the banks."""
    return rules.axes_for("experts", n_routed)


def row_shards(rules: Rules) -> int:
    """Data shards a step's rows are split over on this mesh: the size of
    the ``batch`` axes, 1 when every rank holds all rows (the table's
    ``batch`` replicated, or ``whole_rows``)."""
    axes = rules.table.get("batch")
    if rules.whole_rows or not axes:
        return 1
    return rules.size(axes)


# ---------------------------------------------------------------------------
# Training: placements, the leaf gather and the step's collectives
# ---------------------------------------------------------------------------


def place_train_state(params, opt_state, rules: Rules):
    """This rank's block of every parameter leaf and of both AdamW moments
    (``tree_param_specs``: ``model`` where a dim divides, ``fsdp`` over
    ``data`` when the rules enable it); the step counter is replicated.
    ``opt_state`` an ``optim.adamw.OptState``."""
    return (_place(params, rules, param_spec),
            type(opt_state)(_place(opt_state.m, rules, param_spec),
                            _place(opt_state.v, rules, param_spec),
                            opt_state.step))


def place_params(params, rules: Rules):
    """This rank's block of every parameter leaf (``tree_param_specs``)."""
    return _place(params, rules, param_spec)


def replicas(spec, rules: Rules) -> int:
    """Ranks that hold the same block of a leaf placed by ``spec``: the
    mesh's size over the sizes of the axes that cut it."""
    cut = math.prod(rules.size(a) for a in spec if a)
    return rules.world() // cut


def take_rows(batch: dict, axes, rules: Rules, n_micro: int = 1) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors, rows
    first) split over mesh axes ``axes`` (``batch_pspec``'s; () or None:
    every row).  With ``n_micro`` microbatches the rank takes its shard of
    each microbatch, in microbatch order, as the reference's partitioner
    splits each of ``_accum_grads``' slices over the data shards: the
    rank's own ``n_micro`` equal slices are then exactly those shards."""
    if not axes:
        return batch
    n, idx = rules.size(axes), rules.axis_index(axes)
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        r = v.reshape(n_micro, n, b // (n_micro * n), *v.shape[1:])[:, idx]
        out[k] = r.reshape(b // n, *v.shape[1:])
    return out


def _record(kind: str, t: torch.Tensor) -> None:
    counter = op_count.active()
    if counter is not None:
        counter.add_collective(kind, t.numel() * t.element_size())


def all_gather_dim(x: torch.Tensor, dim: int, axis: str,
                   rules: Rules) -> torch.Tensor:
    """The blocks of the ranks along one mesh axis (all other coordinates
    this rank's), concatenated along ``dim`` in axis order."""
    n = rules.size(axis)
    if n == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= n
    if x.device.type == "meta":
        out = x.new_empty(shape)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=rules.group(axis))
        out = torch.cat(parts, dim=dim)
    _record("all-gather", out)
    return out


def reduce_scatter_dim(x: torch.Tensor, dim: int, axis: str,
                       rules: Rules) -> torch.Tensor:
    """x summed over the ranks along one mesh axis, of which this rank
    keeps its part: ``dim`` cut into equal parts in axis order."""
    n = rules.size(axis)
    if n == 1:
        return x
    parts = [c.contiguous() for c in torch.chunk(x, n, dim=dim)]
    if x.device.type == "meta":
        out = parts[0].new_empty(parts[0].shape)
    else:
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=rules.group(axis))
    _record("reduce-scatter", out)
    return out


def all_reduce(x: torch.Tensor, axes, rules: Rules,
               op: str = "sum") -> torch.Tensor:
    """x reduced (``op`` "sum" or "max") over the ranks that differ along
    mesh axes ``axes``, in place; the whole mesh in one call, else one
    call an axis.  Returns x."""
    axes = tuple(a for a in _axes(axes or ()) if rules.size(a) > 1)
    if not axes:
        return x
    _record("all-reduce", x)
    if x.device.type == "meta":
        return x
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if rules.size(axes) == rules.world():
        dist.all_reduce(x, op=rop)
    else:
        for a in axes:
            dist.all_reduce(x, op=rop, group=rules.group(a))
    return x


def gather_block(x: torch.Tensor, spec, rules: Rules) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block under ``spec``
    (:func:`take_block`'s inverse): each sharded dimension gathered over
    its axes, the minor axis first.  No copy where nothing is cut."""
    for dim, axes in enumerate(spec):
        for a in reversed(_axes(axes or ())):
            x = all_gather_dim(x, dim, a, rules)
    return x


def reduce_block(g: torch.Tensor, spec, rules: Rules,
                 rows) -> torch.Tensor:
    """This rank's block, under ``spec``, of a whole gradient summed over
    the ranks along ``rows`` (the axes the step's rows are split on):
    ``reduce_scatter`` over a row axis that also cuts the leaf, ``narrow``
    over one that does not sum (a ``model`` cut: every model rank computed
    the same contribution), one ``all_reduce`` for the row axes left.
    The sum runs in f32 when any rank is summed over; returns a tensor of
    its own (or ``g`` itself where nothing is cut or summed)."""
    rows = tuple(a for a in (rows or ()) if rules.size(a) > 1)
    if rows and g.is_floating_point() and g.element_size() < 4:
        g = g.to(torch.float32)
    done, cut = set(), False
    for dim, axes in enumerate(spec):
        for a in _axes(axes or ()):
            n = rules.size(a)
            if n == 1:
                continue
            if a in rows:
                g = reduce_scatter_dim(g, dim, a, rules)
                done.add(a)
            else:
                size = g.shape[dim] // n
                g = g.narrow(dim, rules.axis_index(a) * size, size)
                cut = True
    left = tuple(a for a in rows if a not in done)
    if cut:
        g = g.clone()
    return all_reduce(g, left, rules)


class GatherLeaf(torch.autograd.Function):
    """``apply(block, spec, rules, rows)``: the whole parameter leaf from
    this rank's block (:func:`gather_block`); its backward gives the
    block's gradient, the whole gradient summed over ``rows``
    (:func:`reduce_block`) in the block's dtype."""

    @staticmethod
    def forward(ctx, block, spec, rules, rows):
        ctx.spec, ctx.rules, ctx.rows = spec, rules, rows
        ctx.dtype = block.dtype
        return gather_block(block, spec, rules)

    @staticmethod
    def backward(ctx, g):
        return (reduce_block(g, ctx.spec, ctx.rules, ctx.rows).to(ctx.dtype),
                None, None, None)


def specs_like(tree, spec_tree) -> list:
    """The specs of ``spec_tree`` (a spec tree of the same keys) for each
    leaf of ``tree``, in ``core.tree.leaves`` order of ``tree``, whatever
    order ``spec_tree``'s dicts keep."""
    if isinstance(tree, dict):
        return [s for k, v in tree.items()
                for s in specs_like(v, spec_tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v, sv in zip(tree, spec_tree)
                for s in specs_like(v, sv)]
    return [] if tree is None else [spec_tree]

