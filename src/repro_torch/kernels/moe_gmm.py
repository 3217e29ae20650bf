"""Grouped matrix products (the MoE expert FFN) on the GPU: the wrappers of
the hand-written CUDA kernels ``csrc/moe_gmm.cu`` and ``csrc/moe_gmm_small.cu``
(the port of ``repro/kernels/moe_gmm.py::moe_gmm_pallas`` in its two
configurations, and the two products of its backward) and their plain
PyTorch versions.

* ``moe_gmm``: out [T, F] = x [T, D] @ w[e] per group of rows, on one of two
  kernels chosen by the caller's ``block_m`` (``gmm_route``), as the
  reference chooses its row block: 128-row tiles on the tensor cores
  (``moe_gmm.cu``) or, at the small groups of a decode step, a stream of
  each w[e] with the group's rows in registers (``moe_gmm_small.cu``);
* ``moe_gmm_dx``: dx [T, D] = dy [T, F] @ w[e]^T per group of rows;
* ``moe_gmm_dw``: dw [E, D, F], dw[e] = x_e^T @ dy_e over group e's rows.

``moe_gmm_plain`` computes what ``repro/kernels/ref.py::moe_gmm_ref`` does,
as a loop over the groups of ``x[group] @ w[e]``: the reference's oracle form
gathers ``w[eid]`` for every row, which at the LM path's shape would take
2 TB.  ``moe_gmm_dx_plain`` and ``moe_gmm_dw_plain`` are the same loop for
the products of ``repro/models/moe.py::_gmm_matmul_bwd``.

The kernels take float32 tensors whose rows are sorted into
expert-contiguous groups, ``w [E, D, F]`` and ``group_sizes [E]`` (integer,
on the same device), contiguous, 16-byte aligned, with D and F multiples of
4; anything else raises.  The groups need no alignment to any block size;
groups that run past row T are cut there.  Rows past ``sum(group_sizes)``
come out zero in every version, and so does ``dw`` of an empty group.  CPU
tensors take the plain versions through ``repro_torch.kernels.ops``.

The forward also takes bfloat16 ``x`` and ``w`` (the zoo's default dtype),
on bf16 kernels of the same two routes, ``csrc/moe_gmm_bf16.cu`` (``wgmma``
with bf16 operands from TMA-fed, swizzled tiles, one pass, fp32 sums) and
``csrc/moe_gmm_small.cu``'s bf16 kernel (w streamed as bf16, fp32 FMAs, D
split into ``small_chunks`` runs whose fp32 partials the last unit of each
(group, slab) adds in a fixed order), the output rounded to bf16 once, as the
TPU kernel widens its operands and rounds its output (``moe_gmm.py:27-31``);
D and F must then be multiples of 8.  ``moe_gmm_plain`` computes the same
in float32 and rounds once.  Mixed dtypes raise; dX and dW take float32
only (their bf16 kernels belong to the bf16 training slice, ``ROADMAP.md``).
The float32 small-group kernel takes the same split of D, where its
last wave is partial (``small_chunks``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import LaunchCounter, check, load_library, zeroed_tickets

__all__ = [
    "gmm_route",
    "moe_gmm_cuda",
    "moe_gmm_small_cuda",
    "moe_gmm_dx_cuda",
    "moe_gmm_dw_cuda",
    "moe_gmm_plain",
    "moe_gmm_dx_plain",
    "moe_gmm_dw_plain",
    "MOE_GMM_LAUNCHES",
    "MOE_GMM_SMALL_LAUNCHES",
    "MOE_GMM_BF16_LAUNCHES",
    "MOE_GMM_SMALL_BF16_LAUNCHES",
    "SMALL_BLOCK_M",
    "small_rows",
    "small_chunks",
    "MOE_GMM_DX_LAUNCHES",
    "MOE_GMM_DW_LAUNCHES",
]

MOE_GMM_LAUNCHES = LaunchCounter("moe_gmm")  # both routes of the forward
MOE_GMM_SMALL_LAUNCHES = LaunchCounter("moe_gmm_small")  # the small-group route alone
MOE_GMM_BF16_LAUNCHES = LaunchCounter("moe_gmm_bf16")  # both routes of the bf16 forward
MOE_GMM_SMALL_BF16_LAUNCHES = LaunchCounter("moe_gmm_small_bf16")  # its small-group route alone
MOE_GMM_DX_LAUNCHES = LaunchCounter("moe_gmm_dx")
MOE_GMM_DW_LAUNCHES = LaunchCounter("moe_gmm_dw")

ROW_TILE = 128  # rows per output tile of the kernels (kBM in moe_gmm.cu)
# The largest block_m that takes the small-group kernel: from
# ``moe_gmm_variants.py``'s sweep of both kernels over groups of 1-128 rows
# at DeepSeek-V2-Lite's and Jamba's decode products (PERF.md).
SMALL_BLOCK_M = 16
SMALL_MAX_ROWS = 16  # most rows a chunk of the small kernel holds in registers
SMALL_COLS = 128  # columns of F a unit of the small kernel owns (kCols)


def _groups(group_sizes: torch.Tensor):
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        yield e, slice(start, start + size)
        start += size


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x: [T, D] rows grouped by expert (sorted order); w: [E, D, F];
    group_sizes: [E] rows per expert. Returns [T, F] in x's dtype; bfloat16
    operands are widened to float32 and the output rounded back once."""
    dtype = x.dtype
    if dtype == torch.bfloat16:
        x, w = x.float(), w.float()
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    for e, rows in _groups(group_sizes):
        out[rows] = x[rows] @ w[e]
    return out.to(dtype)


def moe_gmm_dx_plain(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """dy: [T, F] grouped as ``moe_gmm_plain``'s x; w: [E, D, F]. Returns
    dx [T, D], the gradient of ``moe_gmm_plain`` with respect to x."""
    dx = torch.zeros((dy.shape[0], w.shape[1]), dtype=dy.dtype, device=dy.device)
    for e, rows in _groups(group_sizes):
        dx[rows] = dy[rows] @ w[e].T
    return dx


def moe_gmm_dw_plain(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x: [T, D] and dy: [T, F], grouped alike. Returns dw [E, D, F], the
    gradient of ``moe_gmm_plain`` with respect to w (zeros for an empty
    group)."""
    E = group_sizes.shape[0]
    dw = torch.zeros((E, x.shape[1], dy.shape[1]), dtype=x.dtype, device=x.device)
    for e, rows in _groups(group_sizes):
        dw[e] = x[rows].T @ dy[rows]
    return dw


def _validate(fn: str, group_sizes: torch.Tensor, E: int, D: int, F: int, tensors: list,
              dtype: torch.dtype = torch.float32) -> None:
    """Raise unless every (name, tensor, shape) of ``tensors`` is a
    ``dtype``, contiguous, 16-byte aligned CUDA tensor of that shape, all on
    one device, D and F are multiples of 4 (8 for bfloat16), and
    ``group_sizes`` is an integer [E] tensor on that device."""
    device = tensors[0][1].device
    if device.type != "cuda":
        raise ValueError(f"{fn}: tensors must be on a CUDA device, got {device}")
    align = 8 if dtype == torch.bfloat16 else 4
    if D % align or F % align:
        raise ValueError(f"{fn}: D and F must be multiples of {align} for {dtype}, got D={D} F={F}")
    for name, t, shape in tensors:
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype} on {device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    if group_sizes.device != device or group_sizes.shape != (E,) or group_sizes.is_floating_point():
        raise ValueError(f"{fn}: group_sizes must be an integer [{E}] tensor on {device}")


def _ends(group_sizes: torch.Tensor, T: int) -> torch.Tensor:
    """The groups' running row ends cut at T, int64, computed on the device
    so that the launch never waits for them."""
    return torch.cumsum(group_sizes.to(torch.int64), 0).clamp_(max=T)


def _offsets(group_sizes: torch.Tensor, T: int):
    """The groups' running row ends cut at T (``_ends``) and the running
    counts of 128-row tiles of the cut groups, int32, on the device."""
    ends = _ends(group_sizes, T)
    sizes = torch.diff(ends, prepend=ends.new_zeros(1))
    tiles = torch.div(sizes + (ROW_TILE - 1), ROW_TILE, rounding_mode="floor")
    return ends.to(torch.int32), torch.cumsum(tiles, 0).to(torch.int32)


def _launch(name: str, counters: tuple, device: torch.device, *args) -> None:
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, rc, name)
    for counter in counters:
        counter.add()


def gmm_route(block_m: int) -> str:
    """The forward kernel for the caller's row block ``block_m``, the rows
    its groups hold (the reference's ``moe_gmm_pallas`` argument):
    ``"small"`` (``moe_gmm_small.cu``) at and below ``SMALL_BLOCK_M``,
    ``"tile"`` (``moe_gmm.cu``'s 128-row tiles) above."""
    if block_m < 1:
        raise ValueError(f"block_m must be at least 1, got {block_m}")
    return "small" if block_m <= SMALL_BLOCK_M else "tile"


def small_rows(block_m: int) -> int:
    """Most rows a chunk of the small kernel holds (its template argument
    RMAX): the least power of two at or above ``block_m``, at most
    ``SMALL_MAX_ROWS``.  Larger groups are taken in chunks."""
    return min(SMALL_MAX_ROWS, 1 << max(0, block_m - 1).bit_length())


def _check_forward(fn: str, x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> tuple:
    """(T, D, F, E, whether bfloat16) of a forward's valid operands: both
    float32 or both bfloat16."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{fn}: want x [T, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn}: x must be float32 or bfloat16, got {x.dtype}")
    (T, _), (E, D, F) = x.shape, w.shape
    _validate(fn, group_sizes, E, D, F, [("x", x, (T, D)), ("w", w, (E, D, F))], x.dtype)
    return T, D, F, E, x.dtype == torch.bfloat16


def moe_gmm_small_cuda(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                       block_m: int = 2) -> torch.Tensor:
    """The small-group forward kernel; same contract as ``moe_gmm_plain``.
    ``block_m`` sets the rows a chunk holds (``small_rows``); any group
    sizes are taken.  Counts under ``MOE_GMM_LAUNCHES`` and
    ``MOE_GMM_SMALL_LAUNCHES`` (bfloat16: ``MOE_GMM_BF16_LAUNCHES`` and
    ``MOE_GMM_SMALL_BF16_LAUNCHES``)."""
    T, D, F, E, bf16 = _check_forward("moe_gmm_small_cuda", x, w, group_sizes)
    if block_m < 1:
        raise ValueError(f"moe_gmm_small_cuda: block_m must be at least 1, got {block_m}")
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    if not T:
        return out
    ends = _ends(group_sizes, T).to(torch.int32)
    rmax = small_rows(block_m)
    # D split into the chunks that fill the card's last wave, each chunk's
    # fp32 partials in `work`, added in chunk order by the last unit of each
    # (group, column slab) to take its ticket.
    chunks = small_chunks(x.device, D, F, E, rmax, bf16)
    work_ptr = tickets_ptr = None
    if chunks > 1:
        work = torch.empty(chunks * T * F, dtype=torch.float32, device=x.device)
        work_ptr = work.data_ptr()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets_ptr = zeroed_tickets(x.device, stream, E * -(-F // SMALL_COLS)).data_ptr()
    name, counters = (("moe_gmm_small_bf16_launch", (MOE_GMM_BF16_LAUNCHES, MOE_GMM_SMALL_BF16_LAUNCHES))
                      if bf16 else ("moe_gmm_small_launch", (MOE_GMM_LAUNCHES, MOE_GMM_SMALL_LAUNCHES)))
    _launch(name, counters, x.device, x.data_ptr(), w.data_ptr(), ends.data_ptr(), out.data_ptr(),
            work_ptr, tickets_ptr, T, D, F, E, rmax, chunks)
    return out


_chunks: dict = {}


def small_chunks(device: torch.device, D: int, F: int, E: int, rmax: int, bf16: bool) -> int:
    """The chunks of D that fill the small-group kernel's last wave on
    ``device`` at its dtype (``moe_gmm_small.cu``'s ``pick_chunks``: the
    pairs past the full waves each split into as many chunks as fit the
    last wave, at most 8), cached by shape."""
    key = (device.index, D, F, E, rmax, bf16)
    if key not in _chunks:
        lib = load_library()
        fn = "moe_gmm_small_bf16_chunks" if bf16 else "moe_gmm_small_chunks"
        chunks = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(D, F, E, rmax, ctypes.byref(chunks))
        check(lib, rc, fn)
        _chunks[key] = chunks.value
    return _chunks[key]


def moe_gmm_cuda(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                 block_m: int = 128) -> torch.Tensor:
    """The forward on the kernel ``gmm_route(block_m)`` names; same contract
    as ``moe_gmm_plain``."""
    if gmm_route(block_m) == "small":
        return moe_gmm_small_cuda(x, w, group_sizes, block_m)
    T, D, F, E, bf16 = _check_forward("moe_gmm_cuda", x, w, group_sizes)
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    if T:
        ends, tile_ends = _offsets(group_sizes, T)
        name, counter = (("moe_gmm_bf16_launch", MOE_GMM_BF16_LAUNCHES) if bf16 else
                         ("moe_gmm_launch", MOE_GMM_LAUNCHES))
        _launch(name, (counter,), x.device, x.data_ptr(), w.data_ptr(), ends.data_ptr(),
                tile_ends.data_ptr(), out.data_ptr(), T, D, F, E)
    return out


def moe_gmm_dx_cuda(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The dX kernel; same contract as ``moe_gmm_dx_plain``."""
    if dy.dim() != 2 or w.dim() != 3:
        raise ValueError(f"moe_gmm_dx_cuda: want dy [T, F] and w [E, D, F], got "
                         f"{tuple(dy.shape)} and {tuple(w.shape)}")
    (T, _), (E, D, F) = dy.shape, w.shape
    _validate("moe_gmm_dx_cuda", group_sizes, E, D, F, [("dy", dy, (T, F)), ("w", w, (E, D, F))])
    dx = torch.empty((T, D), dtype=torch.float32, device=dy.device)
    if T:
        ends, tile_ends = _offsets(group_sizes, T)
        _launch("moe_gmm_dx_launch", (MOE_GMM_DX_LAUNCHES,), dy.device, dy.data_ptr(), w.data_ptr(),
                ends.data_ptr(), tile_ends.data_ptr(), dx.data_ptr(), T, D, F, E)
    return dx


def moe_gmm_dw_cuda(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The dW kernel; same contract as ``moe_gmm_dw_plain``.  Each element
    of dw is summed by one lane in a fixed order: the same from run to
    run."""
    if x.dim() != 2 or dy.dim() != 2 or group_sizes.dim() != 1:
        raise ValueError(f"moe_gmm_dw_cuda: want x [T, D], dy [T, F] and group_sizes [E], got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)} and {tuple(group_sizes.shape)}")
    (T, D), F, E = x.shape, dy.shape[1], group_sizes.shape[0]
    _validate("moe_gmm_dw_cuda", group_sizes, E, D, F, [("x", x, (T, D)), ("dy", dy, (T, F))])
    dw = torch.empty((E, D, F), dtype=torch.float32, device=x.device)
    if E:
        ends, _ = _offsets(group_sizes, T)
        _launch("moe_gmm_dw_launch", (MOE_GMM_DW_LAUNCHES,), x.device, x.data_ptr(), dy.data_ptr(),
                ends.data_ptr(), dw.data_ptr(), T, D, F, E)
    return dw
