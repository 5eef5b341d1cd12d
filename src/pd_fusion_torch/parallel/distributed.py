"""Several cards: one process per card, ``torch.distributed`` between them.

The JAX package is one controller over all its devices: it puts arrays on
a ``("fold", "data")`` mesh and XLA inserts the collectives. The port runs
one process per card, started by ``torchrun``::

    torchrun --standalone --nproc-per-node N -m pd_fusion_torch.cli run ...

and writes its collectives out. This module holds what every such path
shares:

- ``setup`` / ``teardown``: the default process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``). Without that
  environment nothing is set up: world size 1, no mesh, and every caller
  runs the code it runs on one card.
- The backend rule (``resolve_backend``): NCCL when every local rank has
  a card of its own; gloo on the CPU; gloo for ranks that share a card,
  asked for by ``PD_FUSION_TORCH_DIST_BACKEND=gloo`` (NCCL refuses two
  ranks on one device). NCCL asked for with no card, or with more local
  ranks than cards, raises and names the variable: the backend never
  changes behind the caller's back.
- The ``("fold", "data")`` mesh (``fold_data_mesh``): a ``DeviceMesh``
  over the first ``fold * data`` ranks, laid out row-major as the JAX
  package's ``devices.reshape(fold, data)``. Its two sub-groups are made
  with the process-group timeout; ranks past ``fold * data`` are not in
  it and receive results by ``broadcast`` from rank 0.
- The collectives: ``all_reduce`` (sum), ``all_gather`` and
  ``broadcast``, nothing else, so gloo carries them on CUDA tensors too.
  ``all_reduce_grads`` sums a list of gradients in one flat buffer;
  ``gather_folds`` and ``gather_rows`` reassemble what the ranks hold in
  fold or row order on every rank; ``broadcast_object`` sends a small
  picklable value (the run id) from rank 0.
- ``build_native_once``: the K1 library and the host IO library are
  compiled at first use; under a process group the first local rank
  builds them while the others wait, then the others load the cached
  files.

Every collective is bounded by the process-group timeout,
``PD_FUSION_TORCH_DIST_TIMEOUT`` seconds (600 by default): a rank that
dies leaves the others failing, not hanging.
"""
import contextlib
import datetime
import os
import pickle
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKEND_ENV = "PD_FUSION_TORCH_DIST_BACKEND"
TIMEOUT_ENV = "PD_FUSION_TORCH_DIST_TIMEOUT"
DEFAULT_TIMEOUT_S = 600.0

def launched() -> bool:
    """True under a launcher that set torchrun's environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """Rank 0, or the only process: the one that writes artifacts."""
    return rank() == 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))


def timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)))


def resolve_backend(device: torch.device) -> str:
    """``PD_FUSION_TORCH_DIST_BACKEND`` when set, else NCCL on a card and
    gloo on the CPU. NCCL with no card, or with more local ranks than
    cards, raises."""
    asked = os.environ.get(BACKEND_ENV)
    backend = (asked or ("nccl" if device.type == "cuda" else "gloo")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={asked!r}: use 'nccl' or 'gloo'")
    if backend == "nccl":
        if device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(
                f"the NCCL backend needs a CUDA device and this rank runs on {device}; set "
                f"{BACKEND_ENV}=gloo for ranks on the CPU")
        n_cards = torch.cuda.device_count()
        if local_world_size() > n_cards:
            raise RuntimeError(
                f"{local_world_size()} local ranks and {n_cards} card(s): NCCL refuses two "
                f"ranks on one device; set {BACKEND_ENV}=gloo to share a card")
    return backend


def setup(device=None) -> bool:
    """Initialise the default process group from torchrun's environment
    (once). -> True when a group is up. Without a launcher: False, and
    nothing changes."""
    if initialized():
        return True
    if not launched():
        return False
    from pd_fusion_torch.utils.device import get_device

    dev = get_device(device)
    backend = resolve_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=timeout())
    return True


def teardown():
    """Destroy the process group (and the meshes made on it)."""
    _meshes.clear()
    if initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(kernels: bool = False, host: bool = False):
    """An entry point's process group: set up from torchrun's environment
    (unless one is up already), the native libraries built once
    (``build_native_once``), torn down at exit if it was made here.
    Without a launcher: nothing."""
    owned = not initialized() and setup()
    try:
        build_native_once(kernels, host)
        yield
    finally:
        if owned:
            teardown()


def backend() -> Optional[str]:
    return dist.get_backend() if initialized() else None


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective's buffer must lie: NCCL reduces on the card."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _size(group) -> int:
    """Ranks in ``group`` (``None``: the world); 1 without a process group."""
    return dist.get_world_size(group) if initialized() else 1


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` (``None``: the world) of ``t``, a new tensor on
    ``t``'s device; ``t`` itself on one rank."""
    if _size(group) <= 1:
        return t
    buf = _wire(t)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_reduce_differentiable(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``t`` through
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces the gradient (train-mode BN over several ranks)."""
    from torch.distributed.nn.functional import all_reduce as _all_reduce

    with warnings.catch_warnings():
        # deprecated in favour of the functional collectives, which have no
        # backward for this use
        warnings.simplefilter("ignore", FutureWarning)
        return _all_reduce(t, group=group)


def barrier(group=None):
    """Every rank of ``group`` has reached this point (an all-reduce of one
    element: the three collectives are all the port uses)."""
    if _size(group) > 1:
        all_reduce(torch.zeros(1, device=_default_device()), group)


def _default_device() -> torch.device:
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each gradient summed over ``group``, in one flat all-reduce. -> new
    tensors (the inputs untouched); the inputs themselves on a group of one."""
    grads = list(grads)
    if _size(group) <= 1:
        return grads
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at: at + g.numel()].view_as(g))
        at += g.numel()
    return out


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where the collective runs; bools travel as
    uint8."""
    buf = t.detach().to(_comm_device(t), copy=True).contiguous()
    return buf.to(torch.uint8) if buf.dtype == torch.bool else buf


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on all), in group-rank order."""
    if _size(group) <= 1:
        return [t]
    buf = _wire(t)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return [p.to(t.device, t.dtype) for p in parts]


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a global rank) on every rank of ``group``; the
    receivers' ``t`` gives the shape and dtype."""
    if _size(group) <= 1:
        return t
    buf = _wire(t)
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device, t.dtype)


def broadcast_object(obj, src: int = 0):
    """A small picklable value from rank ``src`` on every rank (the run id):
    its length, then its bytes."""
    if world_size() <= 1:
        return obj
    dev = _default_device()
    data = pickle.dumps(obj) if rank() == src else b""
    n = broadcast(torch.tensor([len(data)], dtype=torch.long, device=dev), src)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
    if rank() == src:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    return pickle.loads(broadcast(buf, src).cpu().numpy().tobytes())


# ---------------------------------------------------------------------------
# the ("fold", "data") mesh
# ---------------------------------------------------------------------------


class FoldDataMesh:
    """A ``DeviceMesh`` of shape (fold, data), dims named ``("fold",
    "data")``, over ranks ``0 .. fold*data-1``, and this rank's place in it
    (``member`` False past the mesh: no groups, no coordinates)."""

    def __init__(self, fold: int, data: int, device_mesh):
        self.fold, self.data, self.device_mesh = fold, data, device_mesh
        self.member = device_mesh is not None

    @property
    def shape(self) -> Tuple[int, int]:
        return self.fold, self.data

    @property
    def covers_world(self) -> bool:
        return self.fold * self.data == world_size()

    def group(self, dim: str):
        return self.device_mesh.get_group(dim) if self.member else None

    def index(self, dim: str) -> int:
        return self.device_mesh.get_local_rank(dim) if self.member else -1

    fold_group = property(lambda self: self.group("fold"))
    data_group = property(lambda self: self.group("data"))
    fold_index = property(lambda self: self.index("fold"))
    data_index = property(lambda self: self.index("data"))


_meshes: Dict[Tuple[int, int], FoldDataMesh] = {}


def fold_data_mesh(fold: int, data: int, device_type: str) -> FoldDataMesh:
    """The (fold, data) mesh, made once per shape on this process group. All
    ranks must call it, members or not (sub-group creation is collective)."""
    key = (fold, data)
    if key in _meshes:
        return _meshes[key]
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(fold * data, dtype=torch.int).reshape(fold, data)
    me = rank()
    groups = {}
    # every rank enters every new_group call, in the same order; this
    # rank's fold group holds its column of the mesh, its data group its row
    for dim, lines in (("fold", ranks.T), ("data", ranks)):
        for line in lines.tolist():
            g = dist.new_group(line, timeout=timeout())
            if me in line:
                groups[dim] = g
    device_mesh = None
    if groups:
        device_mesh = DeviceMesh.from_group([groups["fold"], groups["data"]], device_type,
                                            mesh=ranks, mesh_dim_names=("fold", "data"))
    _meshes[key] = FoldDataMesh(fold, data, device_mesh)
    return _meshes[key]


def local_slice(total: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``total`` items split into ``parts`` contiguous
    parts, the first ``total % parts`` one longer (numpy's array_split)."""
    base, extra = divmod(total, parts)
    lo = index * base + min(index, extra)
    return slice(lo, lo + base + (1 if index < extra else 0))


def row_span(n_own: int, group) -> Tuple[int, int]:
    """Rows split over ``group`` by ``local_slice``, this rank holding
    ``n_own`` of them -> (this rank's first row, the group's row count);
    ``(0, n_own)`` for ``group`` None (no group, not the world) or of one
    rank."""
    if group is None or _size(group) <= 1:
        return 0, n_own
    n = int(all_reduce(torch.tensor([n_own]), group).item())
    part = local_slice(n, dist.get_world_size(group), dist.get_rank(group))
    if part.stop - part.start != n_own:
        raise ValueError(f"rank {rank()} holds {n_own} rows; local_slice gives it {part}")
    return part.start, n


def gather_folds(t: torch.Tensor, mesh: FoldDataMesh) -> torch.Tensor:
    """This rank's folds ``t`` [K / fold, ...] -> every fold [K, ...], in fold
    order, on every rank of the mesh."""
    return torch.cat(all_gather(t, mesh.fold_group))


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Each rank's rows [n_r, ...] (contiguous parts, in rank order) ->
    all rows [sum n_r, ...] on every rank. Parts may differ in length: each
    is padded to the longest for the all-gather and cut back after."""
    if _size(group) <= 1:
        return t
    counts = [int(c.item()) for c in all_gather(
        torch.tensor([t.shape[0]], dtype=torch.long, device=t.device), group)]
    longest = max(counts)
    pad = t.new_zeros((longest - t.shape[0], *t.shape[1:]))
    parts = all_gather(torch.cat([t, pad]), group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def build_native_once(kernels: bool, host: bool):
    """Compile the CUDA kernels' libraries (``kernels``: K1 and the fused
    BN, on a CUDA rank only) and the host IO library (``host``) on the
    first local rank while the others wait at a barrier; they then load the
    cached files. Without a process group of several ranks: a no-op (each
    builds at first use)."""
    if world_size() <= 1 or not (kernels or host):
        return
    from pd_fusion_torch.utils.device import get_device

    kernels = kernels and get_device().type == "cuda"
    if local_rank() == 0:
        if kernels:
            from pd_fusion_torch.ops import attention_pool, weighted_bn

            attention_pool.build_library()
            attention_pool.build_library(weighted_bn.SOURCE)
        if host:
            from pd_fusion_torch.imaging import native

            if not native.disabled():
                native.build_library()
    barrier()


def check_collectives() -> dict:
    """``all_reduce``, ``all_gather`` and ``broadcast`` over the world on
    this rank's device, with known answers; raises on a wrong one. -> the
    backend, the world size and (NCCL) its version."""
    from pd_fusion_torch.utils.device import get_device

    dev, r, n = get_device(), rank(), world_size()
    x = torch.arange(4, dtype=torch.float32, device=dev) + r
    summed = all_reduce(x)
    gathered = torch.stack(all_gather(x))
    sent = broadcast(torch.full((3,), 7.0 if r == 0 else -1.0, device=dev), 0)
    want_sum = n * torch.arange(4, dtype=torch.float32) + n * (n - 1) / 2
    want_gather = torch.arange(4, dtype=torch.float32)[None] + torch.arange(n)[:, None]
    if not (torch.equal(summed.cpu(), want_sum) and torch.equal(gathered.cpu(), want_gather)
            and torch.equal(sent.cpu(), torch.full((3,), 7.0))):
        raise RuntimeError(f"rank {r}: collectives gave {summed}, {gathered}, {sent}")
    nccl = None
    if backend() == "nccl":
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
    return {"backend": backend(), "world_size": n, "device": str(dev), "nccl": nccl}


if __name__ == "__main__":
    # torchrun ... -m pd_fusion_torch.parallel.distributed: the collectives
    # of this host's backend on its devices, one JSON line a rank
    import json

    with process_group():
        print(json.dumps({"rank": rank(), **check_collectives()}), flush=True)
