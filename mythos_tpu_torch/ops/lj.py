"""K6: the shifted 12-6 LJ pair energy of the MARTINI nonbonded terms.

Counterpart of mythos_tpu/ops/lj.py. The energy sums, over the masked
pairs under the minimum image, V(r) - V(cutoff) inside the cutoff (1.1 nm),
with x6 = min((sigma^2 / r^2)^3, 1e15) as the TPU kernel forms it
(:func:`_lj_terms`). Kernels hand-written in CUDA (``ops/csrc/lj.cu``)
stand beside their plain PyTorch versions:

* :func:`lj_cells`: the spatial cells of the beads, built on the card from
  the positions and the box (:func:`cell_list_plain` is its plain version);
* :func:`lj_energy` (replaces ``_lj_fwd_impl``): the energy over the mask's
  pairs j > i, each row visiting only the beads of the cells next to its
  own, summed in a fixed order;
* :func:`lj_grads` (replaces ``_lj_vjp_bwd``): the position gradient over
  the symmetric mask and the box gradient -- which the TPU kernel's VJP
  leaves out, and without which a virial loses its image term -- over the
  same cells.

Called alone, :func:`lj_energy` and :func:`lj_grads` each build their own
cells; :class:`LJPairEnergy` builds them once in the forward and hands them
to the backward, so a force evaluation builds one set. :func:`lj_pair_energy`
is the entry. A wrapper runs its plain version for CPU tensors only; on a
CUDA tensor it launches its kernel or raises.

The energy is differentiable to any order in the positions, the box and
the sigma/epsilon tables: its backward is :class:`LJGrads` (K6's backward
kernel forward, on the forward's cells), whose own backward is the VJP of
:func:`lj_grads_plain` (:func:`lj_grads_vjp_plain`), and the tables'
gradient of the energy is autograd of :func:`lj_energy_plain`. So a force
or a virial taken with ``create_graph`` carries d / d (positions, box,
tables) into a loss -- direct differentiation through an NPT run -- while
a run without gradients launches the same kernels as before.

The pair mask (:class:`PairMask`) is symmetric and bit-packed, 32 pairs a
word: 13 MB at 10,160 beads, where a float32 (N, N) mask would be 413 MB.
The kernels read the words of the candidates they visit, the plain forward
the upper half (j > i, each pair once). It is built once per term and
device, never per step.
"""

from __future__ import annotations

import ctypes
import dataclasses as dc

import numpy as np
import torch

LJ_CUTOFF = 1.1  # nm, the fixed MARTINI cutoff
MAX_TYPES = 32  # the kernels keep the (t, t) tables in shared memory
ROWS_PER_BLOCK = 8  # lj.cu's LJ_ROWS: the forward's partials, one per block
#: least cell side (lj.cu's LJ_CELL): the cutoff plus a margin far above
#: float32 rounding, so that beads two cells apart are beyond the cutoff
LJ_CELL = 1.1001
MAX_CELLS = 32768  # lj.cu's LJ_MAX_CELLS: the cell build's histogram

ERR_BOX = "the minimum image needs every box side above twice the LJ cutoff ({}); got box {}"


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) as the int32 of the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(R, W * 32) bool -> (R, W) int32, bit c % 32 of word c // 32."""
    r, m = bits.shape
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _to_int32((bits.reshape(r, m // 32, 32).to(torch.int64) << shifts).sum(-1))


@dc.dataclass(frozen=True)
class PairMask:
    """The interacting pairs of n beads, symmetric and bit-packed: bit j % 32
    of word j // 32 of row i, (n, ceil(n / 32)) int32 on one device."""

    n: int
    bits: torch.Tensor

    @property
    def words(self) -> int:
        return self.bits.shape[1]

    @classmethod
    def build(cls, n: int, excluded, device) -> "PairMask":
        """All pairs i != j of n beads minus the ``excluded`` (E, 2) pairs
        (either order): m2.LJ's ``_pair_mask`` symmetrised. Packed 1024 rows
        at a time (an (R, n) int64 temporary)."""
        w = -(-n // 32)
        j = torch.arange(w * 32, device=device)
        bits = []
        for i0 in range(0, n, 1024):
            i = torch.arange(i0, min(n, i0 + 1024), device=device)[:, None]
            bits.append(_pack((j[None] < n) & (j[None] != i)))
        bits = torch.cat(bits)
        ex = np.sort(np.asarray(excluded, dtype=np.int64).reshape(-1, 2), axis=1)
        ex = np.unique(ex[ex[:, 0] != ex[:, 1]], axis=0)
        _clear(bits, np.concatenate([ex[:, 0], ex[:, 1]]), np.concatenate([ex[:, 1], ex[:, 0]]), w)
        return cls(n=n, bits=bits.contiguous())

    def dense(self, rows: slice = slice(None)) -> torch.Tensor:
        """The (rows, n) bool symmetric mask."""
        bits = self.bits[rows]
        j = torch.arange(self.n, device=bits.device)
        return ((bits[:, j >> 5] >> (j & 31)) & 1).bool()

    def upper(self, i0: int, i1: int) -> torch.Tensor:
        """The (i1 - i0, n) bool mask of rows i0:i1 with j > i: each pair once."""
        j = torch.arange(self.n, device=self.bits.device)
        i = torch.arange(i0, i1, device=self.bits.device)[:, None]
        return self.dense(slice(i0, i1)) & (j[None] > i)


def _clear(bits: torch.Tensor, r: np.ndarray, c: np.ndarray, w: int) -> None:
    """Clear bit (r, c) of each distinct pair, in place."""
    if r.size == 0:
        return
    key = r * w + c // 32
    uk, inv = np.unique(key, return_inverse=True)
    val = np.zeros(len(uk), np.int64)
    np.add.at(val, inv, np.left_shift(1, c % 32))  # distinct columns of a word: distinct bits
    flat = bits.view(-1)
    idx = torch.as_tensor(uk, device=bits.device)
    flat[idx] = flat[idx] & _to_int32(torch.as_tensor((2**32 - 1) ^ val, device=bits.device))


def cell_dims(box: torch.Tensor) -> tuple[int, int, int]:
    """The cells along x, y, z, as ``lj.cu``'s ``cell_dims`` takes them:
    floor(box / LJ_CELL) a side in float32 as the kernel divides, at least
    1 and at most MAX_CELLS; then, while their product exceeds MAX_CELLS,
    the largest count loses one (x before y before z on ties). Cells never
    get thinner than LJ_CELL, so any box computes; a coarser cell only
    gives each row more candidates (reads the box back to the host)."""
    b = box.detach().to(torch.float32)
    nc = [int(v) for v in torch.floor(b / torch.full_like(b, LJ_CELL)).clamp(1.0, MAX_CELLS).tolist()]
    while nc[0] * nc[1] * nc[2] > MAX_CELLS:
        nc[max(range(3), key=lambda a: nc[a])] -= 1  # max() takes the first of equal counts
    return nc[0], nc[1], nc[2]


def check_box(box: torch.Tensor) -> None:
    """Raise unless every box side exceeds twice the cutoff, which the
    minimum image needs (reads the box back to the host)."""
    if not bool((box.detach() > 2 * LJ_CUTOFF).all()):
        raise ValueError(ERR_BOX.format(2 * LJ_CUTOFF, box.detach().cpu().tolist()))


@dc.dataclass(frozen=True)
class CellList:
    """Spatial cells of n beads in a periodic box, as ``lj.cu``'s cell build
    fills them (int32, on the beads' device): ``dims`` (3,) the cells along
    x, y, z (:func:`cell_dims`); ``cell_of`` (n,)
    the cell (cx * ny + cy) * nz + cz of each bead; ``start`` (MAX_CELLS + 1,)
    the number of beads in the cells below each cell (n from the last cell
    on); ``order`` (n,) the beads by (cell, index)."""

    dims: torch.Tensor
    cell_of: torch.Tensor
    start: torch.Tensor
    order: torch.Tensor


def cell_list_plain(positions, box) -> CellList:
    """Plain version of the cell build: :func:`cell_dims` cells a side; a
    bead's cell coordinate is floor(f * cells) of its wrapped fraction f =
    x / box - floor(x / box), clamped to the last cell, all in float32 as
    the kernel computes it, so positions outside [0, box) bin where their
    image lies."""
    x = positions.detach().to(torch.float32)
    b = box.detach().to(device=x.device, dtype=torch.float32)
    ncx, ncy, ncz = cell_dims(b)
    nc = torch.tensor([ncx, ncy, ncz], dtype=torch.float32, device=x.device)
    total = ncx * ncy * ncz
    f = x / b
    f = f - torch.floor(f)
    c = (f * nc).to(torch.int32).clamp(min=0)
    c = torch.minimum(c, nc.to(torch.int32) - 1)
    cell_of = (c[:, 0] * ncy + c[:, 1]) * ncz + c[:, 2]
    n = x.shape[0]
    order = torch.sort(cell_of.long() * n + torch.arange(n, device=x.device)).values % n
    start = torch.full((MAX_CELLS + 1,), n, dtype=torch.int32, device=x.device)
    start[0] = 0
    start[1 : total + 1] = torch.cumsum(torch.bincount(cell_of, minlength=total), 0)
    dims = torch.tensor([ncx, ncy, ncz], dtype=torch.int32, device=x.device)
    return CellList(dims=dims, cell_of=cell_of, start=start, order=order.to(torch.int32))


def _neighbour_cells(dims) -> torch.Tensor:
    """(cells, k) the distinct cells next to each cell, in the kernels'
    offset order: -1, 0, +1 along an axis of 3 or more cells, 0, +1 along
    an axis of 2 (where the two wrapped neighbours coincide), 0 along an
    axis of 1."""
    axes = []
    for nc in (int(v) for v in dims.tolist()):
        offs = torch.arange(-1, 2) if nc >= 3 else torch.arange(nc)
        axes.append((torch.arange(nc)[:, None] + offs[None, :]) % nc)  # (nc, k_axis)
    ax, ay, az = axes
    ny, nz = ay.shape[0], az.shape[0]
    near = (ax[:, None, None, :, None, None] * ny + ay[None, :, None, None, :, None]) * nz
    return (near + az[None, None, :, None, None, :]).reshape(ax.shape[0] * ny * nz, -1)


def cell_candidates(cells: CellList) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernels' candidate walk: the (row, candidate)
    bead pairs, rows in cell order, each row's candidates the beads of its
    distinct neighbour cells (:func:`_neighbour_cells`), cells in offset
    order, beads by index; itself included. Two (pairs,) int64 tensors on
    the CPU."""
    start, order = cells.start.cpu().long(), cells.order.cpu().long()
    seg = _neighbour_cells(cells.dims)[cells.cell_of.cpu().long()[order]]  # (n, k) each row's neighbour cells
    first, count = start[seg].reshape(-1), (start[seg + 1] - start[seg]).reshape(-1)
    row = torch.repeat_interleave(order, count.reshape(seg.shape).sum(1))
    offset = torch.arange(int(count.sum())) - torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    return row, order[torch.repeat_interleave(first, count) + offset]


def candidate_tests(cells: CellList) -> int:
    """Ordered (row, candidate) pairs each kernel loads for these cells:
    each row visits every bead (itself included) of the cells one cell away
    or less along every axis, periodically (every cell of an axis of 2 or 1
    cells)."""
    return int(cell_candidates(cells)[0].numel())


def _lj_terms(r2: torch.Tensor, sigma: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Shifted energy per pair given squared distances (ref ``_lj_terms``)."""
    inv_r2 = sigma * sigma / r2
    x6 = torch.clamp(inv_r2 * inv_r2 * inv_r2, max=1e15)
    v = 4.0 * eps * (x6 * x6 - x6)
    c6 = (sigma / LJ_CUTOFF) ** 6
    v_c = 4.0 * eps * (c6 * c6 - c6)
    return torch.where(r2 < LJ_CUTOFF * LJ_CUTOFF, v - v_c, torch.zeros_like(v))


def _chunk_rows(n: int, entries: int = 2**24) -> int:
    return max(1, entries // max(n, 1))


#: pair entries a row chunk of :func:`lj_grads_vjp_plain` holds: its
#: double backward saves ~30 float32 tensors of that size (~0.5 GB)
VJP_CHUNK_ENTRIES = 2**22


def _rows_energy(positions, types, mask_rows, box, tables, i0: int, i1: int) -> torch.Tensor:
    """Energy of the pairs (i, j) of rows i0:i1 that ``mask_rows`` keeps
    (dense, differentiable in positions, box and tables)."""
    sigmas, epsilons = tables
    dr = positions[i0:i1, None, :] - positions[None, :, :]
    dr = dr - box * torch.round(dr / box)
    r2 = (dr * dr).sum(-1) + 1e-18
    r2 = torch.where(mask_rows, r2, torch.ones_like(r2))  # masked pairs never reach r^-12
    # the (rows, n) tables gathered by rows, then by columns: their backward
    # is two index_adds, not an index_put into the few table entries (on the
    # card a serial walk of ~n^2 / t^2 duplicates an entry)
    t = types.long()
    ti = t[i0:i1]
    sig = sigmas.index_select(0, ti).index_select(1, t)
    eps = epsilons.index_select(0, ti).index_select(1, t)
    energy = _lj_terms(r2, sig, eps)
    return torch.where(mask_rows, energy, torch.zeros_like(energy)).sum()


def lj_energy_plain(positions, types, pair_mask: PairMask, box, tables) -> torch.Tensor:
    """Plain version of K6: the energy over the mask's upper half, dense by row
    chunks as ``lj_energy_forces_reference`` is; autograd gives the position,
    box and table gradients."""
    check_box(box)
    n = positions.shape[0]
    step = _chunk_rows(n)
    total = positions.new_zeros(())
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        total = total + _rows_energy(positions, types, pair_mask.upper(i0, i1), box, tables, i0, i1)
    return total


def _leaf(t: torch.Tensor, keep: bool) -> torch.Tensor:
    """``t`` itself where ``keep`` and it is on the graph, else a detached leaf."""
    return t if keep and t.requires_grad else t.detach().requires_grad_(True)


def lj_grads_plain(positions, types, pair_mask: PairMask, box, tables):
    """Plain version of K6's backward: (dU/dpositions (N, 3), dU/dbox (3,))
    by autograd of :func:`lj_energy_plain`, one row chunk at a time."""
    check_box(box)
    n = positions.shape[0]
    step = _chunk_rows(n)
    pos = positions.detach().requires_grad_(True)
    b = box.detach().requires_grad_(True)
    tables = tuple(x.detach() for x in tables)
    g_pos, g_box = torch.zeros_like(pos), torch.zeros_like(b)
    with torch.enable_grad():
        for i0 in range(0, n, step):
            i1 = min(n, i0 + step)
            e = _rows_energy(pos, types, pair_mask.upper(i0, i1), b, tables, i0, i1)
            gp, gb = torch.autograd.grad(e, (pos, b))
            g_pos += gp
            g_box += gb
    return g_pos, g_box


def lj_grads_vjp_plain(positions, types, pair_mask: PairMask, box, tables, g_pos, g_box,
                       create_graph: bool = False) -> tuple:
    """The VJP of :func:`lj_grads_plain` for cotangents (g_pos (N, 3),
    g_box (3,)): d/d(positions, box, sigmas, epsilons) of <g_pos, dU/dpos> +
    <g_box, dU/dbox>, the double backward of the energy, one row chunk of
    VJP_CHUNK_ENTRIES pair entries at a time (the peak is one chunk's
    graph). With ``create_graph`` the result stays differentiable in all
    inputs, the cotangents included."""
    check_box(box)
    n = positions.shape[0]
    step = _chunk_rows(n, VJP_CHUNK_ENTRIES)
    ins = [_leaf(t, create_graph) for t in (positions, box, *tables)]
    pos, b, sig, eps = ins
    out = [torch.zeros_like(t) for t in ins]
    with torch.enable_grad():
        for i0 in range(0, n, step):
            i1 = min(n, i0 + step)
            e = _rows_energy(pos, types, pair_mask.upper(i0, i1), b, (sig, eps), i0, i1)
            gp, gb = torch.autograd.grad(e, (pos, b), create_graph=True)
            s = (gp * g_pos).sum() + (gb * g_box).sum()
            d = torch.autograd.grad(s, ins, create_graph=create_graph, allow_unused=True)
            out = [o if di is None else o + di for o, di in zip(out, d, strict=True)]
    return tuple(out)


# Kernel wrappers -------------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _kernel_args(name: str, positions, types, pair_mask: PairMask, box, tables) -> tuple:
    """The C arguments up to the outputs: positions, types, the mask bits,
    n, words, box, tables, t."""
    sigmas, epsilons = tables
    named = {"positions": positions, "types": types, "mask": pair_mask.bits, "box": box, "sigmas": sigmas,
             "epsilons": epsilons}
    for k, v in named.items():
        if v.device.type != "cuda":
            raise ValueError(f"{name}: {k} is on {v.device}, not on the card")
        if not v.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    n, t = positions.shape[0], sigmas.shape[0]
    if positions.shape != (n, 3) or n != pair_mask.n or n < 1:
        raise ValueError(f"{name} takes ({pair_mask.n}, 3) positions, got {tuple(positions.shape)}")
    if any(x.dtype != torch.float32 for x in (positions, box, sigmas, epsilons)):
        raise ValueError(f"{name} computes in float32; got {positions.dtype}, {box.dtype}, {sigmas.dtype}")
    if types.dtype != torch.int32 or types.shape != (n,) or box.shape != (3,):
        raise ValueError(f"{name} takes ({n},) int32 types and a (3,) box")
    if not 1 <= t <= MAX_TYPES or sigmas.shape != (t, t) or epsilons.shape != (t, t):
        raise ValueError(f"{name} takes square sigma/epsilon tables of at most {MAX_TYPES} types")
    return (
        _ptr(positions), _ptr(types), _ptr(pair_mask.bits), ctypes.c_int(n), ctypes.c_int(pair_mask.words),
        _ptr(box), _ptr(sigmas), _ptr(epsilons), ctypes.c_int(t),
    )


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def lj_cells(positions, box) -> CellList:
    """The spatial cells of the beads (:class:`CellList`), built on the card
    by one block from the positions and the box as they are there (the box
    is not read back). CPU tensors run :func:`cell_list_plain`."""
    if positions.device.type == "cpu":
        return cell_list_plain(positions, box)
    from mythos_tpu_torch.ops import _build

    for k, v in {"positions": positions, "box": box}.items():
        if v.device.type != "cuda" or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"lj_cells: {k} must be a contiguous float32 tensor on the card")
    n = positions.shape[0]
    if positions.shape != (n, 3) or box.shape != (3,) or n < 1:
        raise ValueError(f"lj_cells takes (n, 3) positions and a (3,) box, got {tuple(positions.shape)}")
    # one int32 allocation: dims, cell_of, order, tmp (the build's scratch), start
    buf = torch.empty(3 + 3 * n + MAX_CELLS + 1, dtype=torch.int32, device=positions.device)
    dims, cell_of, order, tmp, start = buf.split([3, n, n, n, MAX_CELLS + 1])
    rc = _build.load_library().lj_cells(
        _ptr(positions), ctypes.c_int(n), _ptr(box), _ptr(dims), _ptr(cell_of), _ptr(start), _ptr(order), _ptr(tmp),
        _stream(),
    )
    if rc != 0:
        raise RuntimeError(f"lj_cells launch failed: CUDA error {rc}")
    lj_cells.launches += 1
    return CellList(dims=dims, cell_of=cell_of, start=start, order=order)


lj_cells.launches = 0


def _cell_args(cells: CellList, positions) -> tuple:
    n = positions.shape[0]
    if cells.cell_of.shape != (n,) or cells.start.shape != (MAX_CELLS + 1,) or cells.order.device != positions.device:
        raise ValueError(f"cells of {cells.cell_of.shape[0]} beads on {cells.order.device} for {n} positions on "
                         f"{positions.device}")
    return _ptr(cells.dims), _ptr(cells.cell_of), _ptr(cells.start), _ptr(cells.order)


def _lj_energy(positions, types, pair_mask: PairMask, box, tables, cells: CellList | None = None):
    """:func:`lj_energy` on CUDA tensors over ``cells`` (built from the same
    positions and box), or over cells it builds first: (energy, CellList)."""
    from mythos_tpu_torch.ops import _build

    args = _kernel_args("lj_energy", positions, types, pair_mask, box, tables)
    if cells is None:
        cells = lj_cells(positions, box)
    n = pair_mask.n
    partials = torch.empty(-(-n // ROWS_PER_BLOCK), dtype=torch.float32, device=positions.device)
    out = torch.empty((), dtype=torch.float32, device=positions.device)
    rc = _build.load_library().lj_energy(*args, *_cell_args(cells, positions), _ptr(partials), _ptr(out), _stream())
    if rc != 0:
        raise RuntimeError(f"lj_energy launch failed: CUDA error {rc}")
    lj_energy.launches += 1
    return out, cells


def lj_energy(positions, types, pair_mask: PairMask, box, tables) -> torch.Tensor:
    """K6 forward: the energy (a 0-d tensor) over the mask's pairs j > i,
    visiting each row's neighbour cells, which it builds first
    (:func:`lj_cells`). CPU tensors run :func:`lj_energy_plain`."""
    if positions.device.type == "cpu":
        with torch.no_grad():
            return lj_energy_plain(positions, types, pair_mask, box, tables)
    return _lj_energy(positions, types, pair_mask, box, tables)[0]


lj_energy.launches = 0


def _lj_grads(positions, types, pair_mask: PairMask, box, tables, cells: CellList | None = None):
    """:func:`lj_grads` on CUDA tensors over ``cells`` (built from the same
    positions and box), or over cells it builds first: (grad, box_grad,
    CellList)."""
    from mythos_tpu_torch.ops import _build

    args = _kernel_args("lj_grads", positions, types, pair_mask, box, tables)
    if cells is None:
        cells = lj_cells(positions, box)
    n = pair_mask.n
    grad = torch.empty((n, 3), dtype=torch.float32, device=positions.device)
    box_rows = torch.empty((n, 3), dtype=torch.float32, device=positions.device)
    box_grad = torch.empty(3, dtype=torch.float32, device=positions.device)
    rc = _build.load_library().lj_grads(
        *args, *_cell_args(cells, positions), _ptr(grad), _ptr(box_rows), _ptr(box_grad), _stream(),
    )
    if rc != 0:
        raise RuntimeError(f"lj_grads launch failed: CUDA error {rc}")
    lj_grads.launches += 1
    return grad, box_grad, cells


def lj_grads(positions, types, pair_mask: PairMask, box, tables):
    """K6 backward: (dU/dpositions (N, 3) over the whole mask, dU/dbox
    (3,) over each pair once), visiting each row's neighbour cells, which
    it builds first (:func:`lj_cells`). CPU tensors run
    :func:`lj_grads_plain`."""
    if positions.device.type == "cpu":
        return lj_grads_plain(positions, types, pair_mask, box, tables)
    grad, box_grad, _ = _lj_grads(positions, types, pair_mask, box, tables)
    return grad, box_grad


lj_grads.launches = 0


def _vjp(fn, xs: tuple, cots: tuple) -> tuple:
    """d/d xs of <cots, fn(*xs)>, by autograd of ``fn`` on fresh leaves (the
    partial derivatives; zeros for an unused input)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in xs]
        g = torch.autograd.grad(fn(*leaves), leaves, cots, allow_unused=True)
    return tuple(torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, leaves, strict=True))


class _Plain(torch.autograd.Function):
    """``_Plain.apply(fn, *xs)``: the tuple ``fn(*xs)`` of a plain version,
    computed on detached inputs without a graph; its backward is the VJP of
    ``fn`` by autograd (:func:`_vjp`), itself a ``_Plain``, so that the
    result is differentiable to any order in ``xs`` (and in the
    cotangents). ``fn`` builds its outputs on the graph of its arguments
    where grad mode is on."""

    @staticmethod
    def forward(fctx, fn, *xs):
        fctx.fn = fn
        fctx.save_for_backward(*xs)
        return fn(*(x.detach() for x in xs))

    @staticmethod
    def backward(fctx, *cots):
        xs = fctx.saved_tensors
        n, fn = len(xs), fctx.fn

        def vjp(*args):
            return _vjp(fn, args[:n], args[n:])

        return (None, *_Plain.apply(vjp, *xs, *cots))


def _grads_on(positions, box, sigmas, epsilons, types, pair_mask: PairMask, cells: CellList | None):
    """:func:`lj_grads`, on the card over ``cells`` where given."""
    tables = (sigmas, epsilons)
    if positions.device.type == "cpu" or cells is None:
        return lj_grads(positions, types, pair_mask, box, tables)
    grad, box_grad, _ = _lj_grads(positions, types, pair_mask, box, tables, cells)
    return grad, box_grad


class LJGrads(torch.autograd.Function):
    """K6's backward as a differentiable function: ``LJGrads.apply(positions,
    box, sigmas, epsilons, types, pair_mask, cells)`` -> (dU/dpositions (N, 3),
    dU/dbox (3,)). The forward is :func:`lj_grads` -- on the card K6's
    backward kernel over ``cells`` (those :class:`LJPairEnergy`'s forward
    built; None builds them), its plain version on the CPU; the backward is
    :func:`lj_grads_vjp_plain`, the plain double backward, with respect to
    the positions, the box and both tables, itself differentiable again."""

    @staticmethod
    def forward(fctx, positions, box, sigmas, epsilons, types, pair_mask, cells):
        fctx.save_for_backward(positions, box, sigmas, epsilons, types)
        fctx.pair_mask = pair_mask
        return _grads_on(positions, box, sigmas, epsilons, types, pair_mask, cells)

    @staticmethod
    def backward(fctx, g_pos, g_box):
        positions, box, sigmas, epsilons, types = fctx.saved_tensors
        mask = fctx.pair_mask

        def vjp(pos, b, sig, eps, gp, gb):
            return lj_grads_vjp_plain(pos, types, mask, b, (sig, eps), gp, gb, create_graph=torch.is_grad_enabled())

        return (*_Plain.apply(vjp, positions, box, sigmas, epsilons, g_pos, g_box)[:4], None, None, None)


class LJPairEnergy(torch.autograd.Function):
    """The LJ pair energy: :func:`lj_energy` forward; backward the position
    and box cotangents from K6's backward kernel on the cells the forward
    built (one build a force evaluation) -- through :class:`LJGrads`, so
    differentiable again, where the backward builds a graph -- and, where
    the sigma/epsilon tables need a gradient, theirs by autograd of
    :func:`lj_energy_plain`."""

    @staticmethod
    def forward(fctx, positions, box, types, pair_mask, sigmas, epsilons):
        fctx.save_for_backward(positions, box, types, sigmas, epsilons)
        fctx.pair_mask = pair_mask
        if positions.device.type == "cpu":
            fctx.cells = None
            return lj_energy(positions, types, pair_mask, box, (sigmas, epsilons))
        energy, fctx.cells = _lj_energy(positions, types, pair_mask, box, (sigmas, epsilons))
        return energy

    @staticmethod
    def backward(fctx, g):
        positions, box, types, sigmas, epsilons = fctx.saved_tensors
        need, mask = fctx.needs_input_grad, fctx.pair_mask
        g_pos = g_box = g_sig = g_eps = None
        if need[0] or need[1]:
            # a Function only where the force itself is differentiated (its
            # host cost is per force evaluation)
            grads = LJGrads.apply if torch.is_grad_enabled() else _grads_on
            grad, box_grad = grads(positions, box, sigmas, epsilons, types, mask, fctx.cells)
            g_pos = g * grad if need[0] else None
            g_box = g * box_grad if need[1] else None
        if need[4] or need[5]:

            def table_grads(pos, b, sig, eps):
                create_graph = torch.is_grad_enabled()
                with torch.enable_grad():
                    sig_, eps_ = _leaf(sig, create_graph), _leaf(eps, create_graph)
                    e = lj_energy_plain(pos, types, mask, b, (sig_, eps_))
                    return torch.autograd.grad(e, (sig_, eps_), create_graph=create_graph)

            g_sig, g_eps = (g * t for t in _Plain.apply(table_grads, positions, box, sigmas, epsilons))
        return g_pos, g_box, None, None, g_sig, g_eps


def lj_pair_energy(positions, types, pair_mask: PairMask, box, tables) -> torch.Tensor:
    """Total shifted-LJ energy over the masked pairs (ref ``lj_pair_energy``):
    differentiable in ``positions``, ``box`` and the tables, to any order. CPU tensors take the plain
    versions; CUDA tensors the K6 kernels, or it raises."""
    box = torch.as_tensor(box, dtype=positions.dtype, device=positions.device)
    sigmas, epsilons = tables
    return LJPairEnergy.apply(positions, box, types, pair_mask, sigmas, epsilons)
