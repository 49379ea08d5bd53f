"""Executor layer of the serving engine (port of ``repro.serve.executor``):
the device residency of params, cache and the per-slot sampling
generators, and the engine's protection plan.

``LocalExecutor``
    One device: the full params and cache, ``model_parallel == 1``, the
    plan from the model's full GEMM shapes.

``MeshExecutor``
    Sharded serving over a ``(data=d, model=k)`` mesh of d x k process
    ranks (``distributed/mesh.py``; ``distributed/spawn.py`` starts
    them).  This rank holds its shard of the params under the
    reference's rules (``Model.shard_params``: heads, FFN and vocab over
    ``model``; experts, or each expert's FFN dim, over ``model``; a Mamba2
    mixer's heads and channels; and, for a model of at least
    ``sharding.FSDP_THRESHOLD`` parameters, each weight's other dim over
    ``data`` as well: FSDP) and of the KV cache and per-slot state under
    ``cache_specs``: paged pools shard their kv-head dim and the host
    block table stays one logical table, the same on every rank.  Where
    the kv heads do not divide the model axis the cache keeps every kv
    head on every rank (``cache_specs``' ``kv_fallback="replicate"``;
    ``models/attention.py``).  The layers run their collectives through
    the context's groups (``LayerCtx.tp``, ``LayerCtx.dp``), the runner
    ORs every call's flag over the world and the sampler reads the
    gathered logits, so every rank takes the same host decisions step for
    step.  ``init_generators`` seeds every rank alike.

    Over ``data`` the ranks are replicas that split the slots
    (``layout``): where the slots divide the data axis, data rank r
    holds slots [r B/d, (r + 1) B/d) of a dense cache (and of every
    per-slot state) and a decode or verify step runs those rows alone,
    its logits gathered over ``data``; a prefill, a prefix prefill and a
    chunk run the whole admission batch on every data rank (the MoE
    dispatch groups follow the batch's token order), each rank writing
    the cells it holds, and a paged pool stays whole on every data rank.
    With fewer slots than data ranks a dense cache splits its positions
    instead (``cache_specs``' sequence shard) and every rank runs every
    slot, a decode step merging the ranks' attention partials; with
    slots that the axis does not divide, every data rank holds and runs
    everything.

    The plan is the per-shard plan, ``model_parallel=k``, at the rows a
    rank runs (``n_tokens = slots // d`` where decode is split), and it
    is the one that runs: ``protected_matmul`` selects each scheme from
    the rank's own GEMM dims.  (The reference resolves its schemes at
    trace time on GSPMD's logical shapes, so at ``mesh=k`` it executes
    the TP=1 selections while its plan reports per-shard ones, and its
    plan takes ``n_tokens=slots`` at any data width; the port does not
    mirror either.)

    A row-parallel GEMM sums f32 partials and rounds once after the sum,
    so a bf16 model's streams at any width equal the unsharded ones but
    for a rounding in the last place where the reordered f32 sum crosses
    a bf16 boundary.  At ``model == 1`` there are no such collectives and
    no f32 partials.

    The stacks that serve sharded: GQA and MLA attention (with one MTP
    head) and Mamba2 mixers with dense FFNs, MoE FFNs (``models/moe.py``:
    expert-parallel when the experts divide the axis, else each expert's
    FFN dim sliced) or none.  Cross-attention, encoder-decoder and vision
    stacks, a ``pod`` axis wider than 1, and a layout that splits a q
    head or an SSD head raise ``NotImplementedError`` (ROADMAP
    A.3b-ii); so does speculation over a sequence-sharded cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model, layer_tags


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  No CUDA and no explicit request is an error, never a silent
    CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev


def strict_f32(device) -> None:
    """On a CUDA device, keep f32 products in f32: no TF32 in cuBLAS
    matmuls or cuDNN convolutions (whisper's conv stem), no reduced-
    precision bf16 reductions.  The ABFT thresholds assume f32
    accumulation.  Process-wide flags of torch; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction = False


def tree_to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree


class LocalExecutor:
    """Single-device executor: owns params and cache (the engine swaps in
    the cache list a decode step commits)."""

    mesh = None
    model_parallel = 1
    data_parallel = 1
    tp = dp = world = None
    # the logical slots a split call runs (lo, n), and the dense cache's
    # layout over the data ranks (``layers.CacheSplit``): None, whole
    rows = None
    cache_split = None

    def __init__(self, model: Model, params, *, dtype, device, hints=None):
        self.model = model
        self.device = device
        self.params = tree_to(params, device)
        self.dtype = dtype
        self.dtype_bytes = dtype.itemsize
        self.hints = hints
        self.cache = None
        self.gens: list = []

    def init_generators(self, seed: int, slots: int) -> None:
        """One ``torch.Generator`` per slot on the engine's device, each
        seeded from ``seed`` through numpy's ``SeedSequence`` (the slots'
        streams are independent)."""
        seeds = np.random.SeedSequence(int(seed)).generate_state(slots)
        self.gens = [torch.Generator(device=self.device).manual_seed(int(s))
                     for s in seeds]

    def init_dense_cache(self, slots: int, max_len: int) -> None:
        self.cache = self.model.init_cache(slots, max_len, dtype=self.dtype,
                                           device=self.device)

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         slots: int) -> None:
        self.cache = self.model.init_paged_cache(
            num_blocks, block_size, dtype=self.dtype, device=self.device,
            slots=slots)

    def layout(self, slots: int, max_len: int, paged: bool) -> None:
        """Settle how the slots lie over the data ranks (``rows``,
        ``cache_split``); one device holds them all."""

    def local_cells(self, cells, paged: bool):
        """The cells of ``cells`` (``engine.Cells``) this rank holds, at
        its local index; one device holds them all."""
        return cells

    def protection_plan(self, abft, *, slots: int):
        """The ProtectionPlan for this executor's view: per-shard GEMM
        shapes under ``model_parallel``-way TP, at the rows a decode step
        of this rank runs (its own slots where decode is split)."""
        n = self.rows[1] if self.rows is not None else slots
        return self.model.protection_plan(
            hw=abft.hardware, policy=abft.effective_policy(),
            phase="serve", n_tokens=n, dtype_bytes=self.dtype_bytes,
            model_parallel=self.model_parallel)


SHARDABLE_TAGS = frozenset({"attn:dense:0", "attn:moe:0", "mla:dense:0",
                            "mla:moe:0", "mamba:none:0", "mamba:dense:0",
                            "mamba:moe:0"})
# the layer kinds the sharding rules lay out over a mesh: the engine's,
# and the vision model's cross layers, which train sharded
LAYOUT_TAGS = SHARDABLE_TAGS | {"attn:dense:1"}


def check_layout(cfg, mesh) -> None:
    """Raise ``NotImplementedError`` unless the rules lay ``cfg`` out over
    ``mesh`` as the port runs it (``model > 1`` or ``data > 1``): GQA or
    MLA attention or Mamba2 mixers with dense, MoE or no FFNs, cross
    layers over a memory (``LAYOUT_TAGS``), at most one MTP head, no
    ``pod`` axis wider than 1; q heads (after TP head padding,
    ``eff_counts``) that divide the model axis, kv heads that divide it
    or that it divides, and SSD heads that divide it wherever the rules
    split ``d_inner``; a cross layer's unpadded heads likewise.  What
    stays refused names its ROADMAP item."""
    from repro_torch.models.attention import eff_counts

    k = int(mesh.shape["model"])
    tags = set(layer_tags(cfg))
    if not tags <= LAYOUT_TAGS or cfg.mtp_depth > 1:
        raise NotImplementedError(
            f"sharding {cfg.name} ({sorted(tags)}): GQA, MLA and Mamba2 "
            f"mixers with dense, MoE or no FFNs, cross layers and one MTP "
            f"head shard over a mesh")
    if any(mesh.shape[a] > 1 for a in mesh.axis_names
           if a not in ("data", "model")):
        raise NotImplementedError(
            f"sharding over {mesh.shape}: a pod axis is not ported; the "
            f"mesh must be (data=d, model=k); ROADMAP A.3b-ii")
    if any(t.startswith("mla") for t in tags):
        if cfg.n_heads % k:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.n_heads} MLA heads do not divide "
                f"model={k}: the rules would split a q head; ROADMAP "
                f"A.3b-ii")
    hd = cfg.resolved_head_dim
    heads = []
    if any(t.startswith("attn") for t in tags):
        heads.append(eff_counts(cfg))
    if any(t.endswith(":1") for t in tags):
        heads.append((cfg.n_heads, cfg.n_kv_heads))
    for H, KV in heads:
        if (H * hd) % k == 0 and H % k:
            raise NotImplementedError(
                f"{cfg.name}: the rules split a q head over model={k} "
                f"({H} heads; pad_heads_to pads them to a multiple); "
                f"ROADMAP A.3b-ii")
        if (KV * hd) % k == 0 and KV % k and k % KV:
            raise NotImplementedError(
                f"{cfg.name}: {KV} kv heads over model={k} neither divide "
                f"nor are divided by the axis; ROADMAP A.3b-ii")
    if any(t.startswith("mamba") for t in tags) \
            and cfg.d_inner % k == 0 and cfg.ssm_heads % k:
        raise NotImplementedError(
            f"{cfg.name}: the rules split an SSD head over model={k} "
            f"({cfg.ssm_heads} heads); ROADMAP A.3b-ii")


def check_shardable(cfg, mesh) -> None:
    """Raise ``NotImplementedError`` unless the engine serves ``cfg``
    sharded over ``mesh``: stacks with a memory (cross-attention,
    encoder-decoder, vision) raise, as the engine serves them at no width
    (the reference's cannot: it passes only tokens); the rest as
    ``check_layout``."""
    if cfg.is_encoder_decoder or cfg.vision_dim or cfg.cross_attn_every:
        raise NotImplementedError(
            f"sharded serving of {cfg.name}: the engine serves stacks with "
            f"a memory (cross-attention, encoder-decoder, vision) at no "
            f"width, as the reference's cannot (it passes only tokens); "
            f"drive them through Model.forward/prefill/decode")
    check_layout(cfg, mesh)


def _layer_specs(specs) -> list:
    """Every layer's spec dict: the decoder's, the MTP head's layer and
    the encoder's (their leaves share the paths below a layer)."""
    layers = list(specs["layers"])
    if "mtp" in specs:
        layers.append(specs["mtp"]["layer"])
    if "encoder" in specs:
        layers += list(specs["encoder"]["layers"])
    return layers


def sharded_paths(specs) -> frozenset:
    """The leaves a spec tree splits over ``model``: each layer leaf by
    its path below the layer (``"ffn/shared/up"``), the MTP head's layer
    (``mtp/layer``) and the encoder's layers among them, the embedding
    and head by name (``TPGroup.sharded``)."""
    from repro_torch.distributed.sharding import map_with_path

    out = set()
    for lp in _layer_specs(specs):
        map_with_path(lambda ps, sp: out.add(ps) if "model" in sp else None,
                      lp)
    out |= {n for n in ("embed", "lm_head")
            if n in specs and "model" in specs[n]}
    return frozenset(out)


def fsdp_dims(specs) -> dict:
    """The leaves a spec tree splits over ``data`` (FSDP), each by the
    path ``sharded_paths`` gives it, with the dim the axis splits."""
    from repro_torch.distributed.sharding import map_with_path

    out = {}

    def one(ps, sp):
        for i, e in enumerate(sp):
            if e == "data" or (isinstance(e, tuple) and "data" in e):
                out[ps] = i

    for lp in _layer_specs(specs):
        map_with_path(one, lp)
    for n in ("embed", "lm_head"):
        if n in specs:
            one(n, specs[n])
    return out


def axis_groups(model: Model, mesh) -> tuple:
    """This rank's ``TPGroup`` on each axis of a sharded ``mesh``: (tp,
    dp), each None where its axis is one wide.  ``tp.sharded``: the
    leaves the rules split over ``model`` (``sharded_paths``);
    ``dp.sharded``/``dp.dims``: those they split over ``data`` (FSDP,
    ``fsdp_dims``)."""
    from repro_torch.distributed.collectives import TPGroup, backend_of
    from repro_torch.distributed.sharding import param_specs

    k = int(mesh.shape["model"])
    d = int(mesh.shape.get("data", 1))
    specs = param_specs(model.cfg, model.param_shapes(), mesh)
    tp = dp = None
    if k > 1:
        tp = TPGroup(rank=mesh.model_rank, size=k, group=mesh.group,
                     backend=backend_of(mesh.group),
                     sharded=sharded_paths(specs))
    if d > 1:
        dims = fsdp_dims(specs)
        dp = TPGroup(rank=mesh.data_rank, size=d, group=mesh.data_group,
                     backend=backend_of(mesh.data_group),
                     sharded=frozenset(dims), axis="data", dims=dims)
    return tp, dp


class MeshExecutor(LocalExecutor):
    """Mesh-sharded executor (see the module docstring).  ``mesh``: an
    int tensor-parallel width (a ``(data=1, model=k)`` mesh over this
    process's world, its ranks on ``device``'s type) or a prebuilt port
    ``Mesh`` (``build_mesh(data=d, model=k)``); ``params``: the full
    tree, the same on every rank (each rank keeps its shard), or this
    rank's shard already (``Model.init_params(mesh=)``).

    A virtual mesh (``mesh.virtual_mesh``: the dry run's, on the meta
    device) needs no process group and is checked by ``check_layout``
    alone: the dry run drives ``Model.prefill``/``decode`` with the
    memory inputs the engine does not pass.  Its collectives take meta
    tensors only."""

    def __init__(self, model: Model, params, *, mesh, dtype, device,
                 hints=None):
        import torch.distributed as dist

        from repro_torch.distributed.collectives import (
            grid_group,
            world_group,
        )
        from repro_torch.distributed.mesh import (
            build_mesh,
            make_hints,
            rank_devices,
        )

        ranked = dist.is_available() and dist.is_initialized()
        if isinstance(mesh, int):
            if mesh > 1 and not ranked:
                raise NotImplementedError(
                    f"model_parallel={mesh} in one process: the port runs "
                    f"one process a rank; start them with "
                    f"repro_torch.distributed.spawn (the serve CLI's "
                    f"--mesh N)")
            mesh = build_mesh(model=mesh, data=1,
                              devices=rank_devices(device.type))
        if "model" not in mesh.axis_names:
            raise ValueError(f"MeshExecutor needs a 'model' axis, mesh has "
                             f"{mesh.axis_names}")
        k = int(mesh.shape["model"])
        d = int(mesh.shape.get("data", 1))
        self.mesh = mesh
        self.model_parallel, self.data_parallel = k, d
        if hints is None:
            hints = make_hints(model.cfg, mesh)
        self.sharded = k > 1 or d > 1
        if self.sharded:
            if mesh.virtual:
                check_layout(model.cfg, mesh)
            else:
                check_shardable(model.cfg, mesh)
                if not ranked:
                    raise NotImplementedError(
                        f"a {mesh.shape} mesh in one process: the port "
                        f"runs one process a rank; start them with "
                        f"repro_torch.distributed.spawn")
            device = mesh.device
            self.tp, self.dp = axis_groups(model, mesh)
            self.world = grid_group(mesh) if mesh.virtual else world_group()
            params = model.shard_params(params, mesh)
        super().__init__(model, params, dtype=dtype, device=device,
                         hints=hints)

    def layout(self, slots: int, max_len: int, paged: bool) -> None:
        """Where the slots divide the data axis, rank r holds and runs
        slots [r B/d, (r + 1) B/d) (``rows``; a dense cache's per-slot
        leaves and every per-slot state split so); with fewer slots than
        ranks a dense cache's positions split instead, where the axis
        divides ``max_len`` (a paged pool never splits); else every data
        rank holds everything (``cache_specs``' rules, read off its
        ``sanitize_spec``)."""
        from repro_torch.models.layers import CacheSplit

        d = self.data_parallel
        if d == 1:
            return
        r = self.mesh.data_rank
        if slots % d == 0:
            n = slots // d
            self.rows = (r * n, n)
            self.cache_split = CacheSplit("slot", r * n, n)
        elif slots < d and not paged and max_len % d == 0:
            n = max_len // d
            self.cache_split = CacheSplit("seq", r * n, n)

    def local_cells(self, cells, paged: bool):
        """The rank's own cells of ``cells`` at their local index: the
        rows of slot-split state leaves, and on a split dense cache the
        (slot, position) cells the rank holds; a paged pool's cells are
        the same on every rank."""
        sp = self.cache_split
        if sp is None:
            return cells
        kv, rows = cells.kv, cells.rows
        if rows is not None and sp.kind == "slot":
            rows = rows[sp.owns(rows)] - sp.lo
        if kv is not None and not paged:
            kv = sp.local(kv)[0]
        return cells._replace(kv=kv, rows=rows)

    def _put_cache(self, cache, *, paged: bool, slots: int) -> list:
        """The rank's shard of a cache laid out on the meta device:
        zeros of each leaf's local shape under ``cache_specs`` (every kv
        head where they do not divide the axis)."""
        from repro_torch.distributed.sharding import (
            cache_specs,
            map_with_path,
            shard_shape,
        )

        specs = cache_specs(self.model.cfg, cache, self.mesh, slots,
                            paged=paged, kv_fallback="replicate")
        flat = {}
        map_with_path(lambda ps, s: flat.__setitem__(ps, s), specs)
        return map_with_path(
            lambda ps, t: torch.zeros(shard_shape(flat[ps], t.shape,
                                                  self.mesh),
                                      dtype=t.dtype, device=self.device),
            cache)

    def init_dense_cache(self, slots: int, max_len: int) -> None:
        if not self.sharded:
            return super().init_dense_cache(slots, max_len)
        self.cache = self._put_cache(
            self.model.init_cache(slots, max_len, dtype=self.dtype,
                                  device="meta"), paged=False, slots=slots)

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         slots: int) -> None:
        if not self.sharded:
            return super().init_paged_cache(num_blocks, block_size, slots)
        self.cache = self._put_cache(
            self.model.init_paged_cache(num_blocks, block_size,
                                        dtype=self.dtype, device="meta",
                                        slots=slots),
            paged=True, slots=slots)
