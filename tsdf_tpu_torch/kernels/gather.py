"""The gathers: the CUDA kernels ``csrc/gather.cu``,
``csrc/gather_rows.cu`` and ``csrc/gather_windowed.cu`` and their wrappers.

``lane_gather_op`` replaces ``tsdf_tpu/kernels/gather.py:lane_gather_op``:
out[s, c] = table[s, idx[s, c]], and 0 where the index is outside
[0, W). The kernel moves 32-bit words, so float32 and int32 tables go
through it unchanged. A table whose rows are one row broadcast (row
stride 0, as ``expand`` gives) is read without being copied.

``row_gather_op`` replaces ``row_gather_op`` of the same JAX module:
out[j, :] = table[idx[j], :] with the index clamped, rows copied as bytes.

``lane_gather_windowed_op`` replaces ``lane_gather_windowed_op``: the lane
gather restricted to a window of the table per tile of ``idx``, with a
count of the in-range indices the windows missed; ``lane_gather_checked``
follows it with the full gather behind a guard on that count, decided on
the device; ``lane_gather_fast`` is the backend dispatch. No path of
either package calls the windowed gather: it is a public function of the
module and is held against its twin like the others.

``gather_probe_cuda`` replaces ``tools/probe_gather_roofline.py``'s
kernel: a probe of the card's in-row gather rate, which no path calls.

The lane gather's launch plan (``lane_gather_launch``) and the windowed
gather's tiling (``window_tiling``) are plain functions of the shapes, so
the CPU tests hold them.

Each wrapper launches its kernel on CUDA tensors and runs its plain twin
only on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import (
    Kernel,
    check_same_device,
    check_tensor,
    library,
    stream_handle,
)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNEL = Kernel(
    "tsdf_lane_gather",
    # table, idx, out, rows, cols, width, row_stride, launch, tile_rows,
    # stream
    [_P, _P, _P, _L, _L, _L, _L, _I, _I, _P],
)
KERNEL_IF_MISSED = Kernel(
    "tsdf_lane_gather_if_missed",
    # table, idx, out, only_if, rows, cols, width, row_stride, stream,
    # tile_rows
    [_P, _P, _P, _P, _L, _L, _L, _L, _P, _I],
)
KERNEL_ROWS = Kernel(
    "tsdf_row_gather",
    # table, idx, out, n_idx, n_rows, row_bytes, stream
    [_P, _P, _P, _L, _L, _L, _P],
)
KERNEL_WINDOWED = Kernel(
    "tsdf_lane_gather_windowed",
    # table, idx, out, miss, rows, cols, width, bs, wb, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
)

LANE = 128

_WORD_TYPES = (torch.float32, torch.int32)

# The lane gather's three launches (csrc/gather.cu), by their codes there.
LAUNCHES = ("broadcast", "rows", "direct")
# a broadcast table of at most this many bytes is staged in shared memory
BROADCAST_SHARED_BYTES = 48 * 1024
# rows of at most this many words are staged a tile at a time ...
ROWS_MAX_WIDTH = 64
# ... a tile of at most this many table words (16 KB), in rows a multiple
# of 4, so that a tile starts 16-byte aligned in the table and the output
ROWS_TILE_WORDS = 4096
# a direct launch's block takes rows until it has at least this many outputs
DIRECT_TILE_OUTPUTS = 2048
# a tile's outputs are counted in 32 bits on the card
_MAX_TILE_OUTPUTS = 2**31 - 1


def take_or_zero(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin: out[s, c] = table[s, idx[s, c]], 0 out of range.
    A ``where``, not a mask multiply, so a NaN or inf in the table never
    leaks into an out-of-range slot."""
    w = table.shape[1]
    in_range = (idx >= 0) & (idx < w)
    g = torch.gather(table, 1, idx.clamp(0, w - 1).to(torch.int64))
    return torch.where(in_range, g, torch.zeros_like(g))


def _check_lane_gather(table, idx, broadcast_ok=True) -> torch.device:
    """Raise on what the lane-gather kernels do not take; returns the
    tensors' device."""
    dev = table.device
    check_same_device(dev, idx=idx)
    if table.dtype not in _WORD_TYPES:
        raise TypeError(f"table: dtype {table.dtype}, expected f32 or i32")
    if table.dim() != 2:
        raise ValueError(f"table: shape {tuple(table.shape)}, expected 2-D")
    s, w = table.shape
    row_strides = (0, w) if broadcast_ok else (w,)
    if table.stride(1) != 1 or table.stride(0) not in row_strides:
        raise ValueError(
            f"table: strides {table.stride()} are neither contiguous nor "
            "a broadcast row" if broadcast_ok else
            f"table: strides {table.stride()}, expected contiguous"
        )
    check_tensor("idx", idx, torch.int32, ndim=2)
    if idx.shape[0] != s:
        raise ValueError(f"table has {s} rows, idx {idx.shape[0]}")
    return dev


def lane_gather_launch(
    cols: int, width: int, row_stride: int
) -> tuple[str, int]:
    """Which of ``csrc/gather.cu``'s launches a lane gather takes, and the
    rows a block of it owns (0 for "broadcast", whose blocks walk one flat
    stream), from the shapes and strides alone:

    * "broadcast": one row broadcast over all (``row_stride`` 0) that fits
      in ``BROADCAST_SHARED_BYTES``: staged in shared memory by each block;
    * "rows": contiguous rows of at most ``ROWS_MAX_WIDTH`` words: a block
      stages its tile of rows in shared memory;
    * "direct": anything else, read in place.

    Raises ValueError where one tile would hold 2^31 outputs or more.
    """
    if row_stride == 0 and width * 4 <= BROADCAST_SHARED_BYTES:
        return "broadcast", 0
    if row_stride == width and 0 < width <= ROWS_MAX_WIDTH:
        launch = "rows"
        tile_rows = max(4, ROWS_TILE_WORDS // width // 4 * 4)
    else:
        launch = "direct"
        tile_rows = max(1, -(-DIRECT_TILE_OUTPUTS // max(cols, 1)))
    if tile_rows * cols > _MAX_TILE_OUTPUTS:
        raise ValueError(f"idx: {cols} columns are too many for one launch")
    return launch, tile_rows


def lane_gather_op(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[s, c] = table[s, idx[s, c]]; an out-of-range index gives 0.

    Args:
      table: (S, W) float32 or int32, unit stride along W and a row stride
        of W (contiguous) or 0 (one row broadcast over S).
      idx: (S, C) int32, contiguous.

    Returns (S, C) of table's dtype. CUDA tensors go through the kernel,
    in the launch ``lane_gather_launch`` picks; CPU tensors through
    ``take_or_zero``.
    """
    dev = _check_lane_gather(table, idx)
    s, w = table.shape
    if dev.type == "cpu":
        return take_or_zero(table, idx)

    c = idx.shape[1]
    out = torch.empty((s, c), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    launch, tile_rows = lane_gather_launch(c, w, table.stride(0))
    with torch.cuda.device(dev):
        KERNEL(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            s, c, w, table.stride(0), LAUNCHES.index(launch), tile_rows,
            stream_handle(dev),
        )
    return out


def lookup_flat(image: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """out[s, c] = image.flatten()[lin[s, c]], 0 where ``lin`` is outside
    the image: a 2-D lookup by linear pixel index ``y * W + x``.

    The image (H, W), float32 or int32 and contiguous, is viewed as one
    row broadcast over ``lin``'s rows (row stride 0), so nothing is
    copied; ``lin`` is (S, C) int32. One call of :func:`lane_gather_op`:
    the kernel on CUDA tensors, ``take_or_zero`` on CPU tensors.
    """
    check_tensor("image", image, image.dtype, ndim=2)
    return lane_gather_op(image.reshape(1, -1).expand(lin.shape[0], -1), lin)


# -- row gather -------------------------------------------------------------


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`row_gather_op`: out[j, :] = table[idx[j], :]
    with ``idx`` clamped to [0, N)."""
    n = table.shape[0]
    return torch.index_select(table, 0, idx.clamp(0, n - 1).to(torch.int64))


def row_gather_op(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[j, :] = table[idx[j], :]: a gather of whole rows.

    Args:
      table: (N, W) of any dtype, contiguous, N >= 1. Rows are copied as
        bytes and the dtype is kept.
      idx: (J,) int32, contiguous. An index outside [0, N) is clamped.

    Returns (J, W) of table's dtype. CUDA tensors go through the kernel,
    CPU tensors through ``take_rows``.
    """
    dev = table.device
    check_same_device(dev, idx=idx)
    check_tensor("table", table, table.dtype, ndim=2)
    check_tensor("idx", idx, torch.int32, ndim=1)
    n, w = table.shape
    if n < 1:
        raise ValueError("table: no rows to gather from")
    if dev.type == "cpu":
        return take_rows(table, idx)

    j = idx.shape[0]
    out = torch.empty((j, w), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        KERNEL_ROWS(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(),
            j, n, w * table.element_size(), stream_handle(dev),
        )
    return out


# The row gather's instances by the code ``tsdf_row_gather_instance``
# returns (csrc/gather_rows.cu); 8 is added where the 12-byte instance loads
# its indices one at a time.
_ROW_GATHER_INSTANCES = ("generic 1 B", "generic 2 B", "generic 4 B",
                         "generic 8 B", "generic 16 B", "rows12", "rows16")


def row_gather_instance(table: torch.Tensor, idx: torch.Tensor) -> str:
    """The instance ``row_gather_op`` launches for these tensors, as the
    library picks it from the row width and the pointers (the output is a
    fresh allocation, which PyTorch aligns to 512 bytes): "rows16",
    "rows12" or "generic N B" (N the bytes of its word); "rows12, scalar
    indices" where ``idx`` is not 8-byte aligned. Needs the kernels
    library, so a card."""
    fn = library().tsdf_row_gather_instance
    fn.argtypes = [_P, _P, _P, _L]
    fn.restype = ctypes.c_int
    code = fn(table.data_ptr(), idx.data_ptr(), 0,
              table.shape[1] * table.element_size())
    name = _ROW_GATHER_INSTANCES[code & 7]
    return name + ", scalar indices" if code & 8 else name


# -- windowed lane gather -----------------------------------------------------


def window_tiling(rows: int, width: int, window_blocks: int, block_rows: int):
    """The tile height and window width of the windowed gather, as the JAX
    kernel derives them: rows are padded to a multiple of 8, the tile
    height is ``block_rows`` halved until it divides the padded count, the
    window is ``window_blocks`` blocks of 128 columns, at most the table.

    Returns (bs, wb).
    """
    if width % LANE != 0 or width == 0:
        raise ValueError(f"table: width {width} is not a multiple of {LANE}")
    if window_blocks < 1 or block_rows < 1:
        raise ValueError("window_blocks and block_rows must be at least 1")
    sp = -(-rows // 8) * 8
    bs = int(block_rows)
    while sp % bs:
        bs //= 2
    return bs, min(int(window_blocks), width // LANE)


def take_windowed(
    table: torch.Tensor,
    idx: torch.Tensor,
    window_blocks: int = 2,
    block_rows: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`lane_gather_windowed_op`. It reproduces the
    kernel's partition of ``idx`` into tiles of ``bs`` rows by 128 columns
    (the miss count depends on it), padding with an out-of-range index."""
    s, w = table.shape
    c = idx.shape[1]
    bs, wb = window_tiling(s, w, window_blocks, block_rows)
    if s == 0 or c == 0:
        return (
            torch.zeros((s, c), dtype=table.dtype, device=table.device),
            torch.zeros((), dtype=torch.int32, device=table.device),
        )
    nt, nc = -(-s // bs), -(-c // LANE)
    padded = torch.full(
        (nt * bs, nc * LANE), w, dtype=torch.int32, device=idx.device
    )
    padded[:s, :c] = idx
    tiles = padded.reshape(nt, bs, nc, LANE)
    in_range = (tiles >= 0) & (tiles < w)
    m = torch.where(in_range, tiles, w - 1).amin(dim=(1, 3), keepdim=True)
    m0 = torch.clamp((m >> 7) << 7, max=w - wb * LANE)
    covered = (tiles >= m0) & (tiles < m0 + wb * LANE)
    covered = covered.reshape(nt * bs, nc * LANE)[:s, :c]
    g = torch.gather(table, 1, idx.clamp(0, w - 1).to(torch.int64))
    out = torch.where(covered, g, torch.zeros_like(g))
    in_range = (idx >= 0) & (idx < w)
    miss = (in_range & ~covered).sum().to(torch.int32)
    return out, miss


def lane_gather_windowed_op(
    table: torch.Tensor,
    idx: torch.Tensor,
    window_blocks: int = 2,
    block_rows: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """out[s, c] = table[s, idx[s, c]] through per-tile index windows.

    ``idx`` is cut into tiles of ``bs`` rows by 128 columns
    (``window_tiling``). A tile's window starts at
    ``m0 = min((m >> 7) << 7, W - wb*128)``, ``m`` the tile's smallest
    in-range index (``W - 1`` if it has none), and spans ``wb*128``
    columns. An element inside its tile's window reads the table; any
    other gives 0.

    Args:
      table: (S, W) float32 or int32, contiguous, W a multiple of 128.
      idx: (S, C) int32, contiguous.

    Returns (out, miss): ``miss`` is a 0-d int32 tensor on the tensors'
    device, the count of in-range indices outside their tile's window:
    ``out`` equals ``lane_gather_op(table, idx)`` exactly iff it is 0.
    Out-of-range indices give 0 and never count. It is not read here.

    CUDA tensors go through the kernel (covered words read in place, a
    block a tile), CPU tensors through ``take_windowed``.
    """
    dev = _check_lane_gather(table, idx, broadcast_ok=False)
    s, w = table.shape
    bs, wb = window_tiling(s, w, window_blocks, block_rows)
    if dev.type == "cpu":
        return take_windowed(table, idx, window_blocks, block_rows)
    c = idx.shape[1]
    out = torch.empty((s, c), dtype=table.dtype, device=dev)
    miss = torch.zeros(1, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out, miss[0]
    with torch.cuda.device(dev):
        KERNEL_WINDOWED(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), miss.data_ptr(),
            s, c, w, bs, wb, stream_handle(dev),
        )
    return out, miss[0]


def lane_gather_checked(
    table: torch.Tensor,
    idx: torch.Tensor,
    window_blocks: int = 2,
    block_rows: int = 64,
) -> torch.Tensor:
    """The windowed gather with an exact fallback decided on the device:
    equal to ``lane_gather_op(table, idx)`` on every input, with no host
    read.

    On CUDA tensors the windowed kernel is followed by a second launch of
    the full lane gather behind a guard (the "direct" tiles of
    ``lane_gather_launch``, on at most the blocks the card holds at once):
    each of its blocks reads the windowed kernel's miss word and returns
    at once when it is 0, else the launch rewrites the output in full. Both
    launches are always queued; the host never sees the count. On CPU
    tensors the twin's count selects between the twins' results with
    ``torch.where``.
    """
    out, miss = lane_gather_windowed_op(table, idx, window_blocks, block_rows)
    dev = table.device
    if dev.type == "cpu":
        return torch.where(miss > 0, take_or_zero(table, idx), out)
    if out.numel() == 0:
        return out
    s, w = table.shape
    # contiguous rows of at least 128 words: always the "direct" launch
    _, tile_rows = lane_gather_launch(idx.shape[1], w, w)
    with torch.cuda.device(dev):
        KERNEL_IF_MISSED(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), miss.data_ptr(),
            s, idx.shape[1], w, table.stride(0), stream_handle(dev),
            tile_rows,
        )
    return out


def lane_gather_fast(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather for locally coherent indices, by device: the checked
    windowed kernels on CUDA tensors, ``take_or_zero`` on CPU tensors. The
    same values as ``lane_gather_op`` on every input."""
    if table.device.type == "cpu":
        _check_lane_gather(table, idx, broadcast_ok=False)
        window_tiling(table.shape[0], table.shape[1], 2, 64)
        return take_or_zero(table, idx)
    return lane_gather_checked(table, idx)


# -- the gather-roofline probe -----------------------------------------------

KERNEL_PROBE = Kernel(
    "tsdf_probe_gather",
    # table, idx, out, rows, g, stream
    [_P, _P, _P, _L, _I, _P],
)
PROBE_GATHERS = 64
# a warp's lanes: 32 consecutive columns of one row; shared-memory banks
_WARP = 32


def probe_wavefronts(idx: torch.Tensor, g: int = PROBE_GATHERS) -> int:
    """Shared-memory wavefronts the probe's gathers take: for each warp
    (32 consecutive columns of a row) and each i < g, the most distinct
    words among its 32 columns ``clip(idx + i, 0, 127)`` that fall in one
    of the 32 banks (one row is 128 words, so column c is bank c % 32).
    Lanes on one word are served at once (a broadcast). The card serves one
    wavefront an SM a clock: the probe's floor."""
    rows = idx.shape[0]
    lanes = idx.reshape(rows, LANE // _WARP, _WARP).to(torch.int64)
    total = torch.zeros((), dtype=torch.int64, device=idx.device)
    for i in range(g):
        cols = torch.clamp(lanes + i, 0, LANE - 1)
        words = torch.zeros((rows, LANE // _WARP, LANE), dtype=torch.bool,
                            device=idx.device)
        words.scatter_(2, cols, True)
        # word c = 32 k + b lies in bank b: a bank's words are k = 0..3
        per_bank = words.reshape(rows, LANE // _WARP, LANE // _WARP, _WARP)
        total += per_bank.sum(dim=2).amax(dim=2).sum()
    return int(total)


def gather_probe_plain(
    table: torch.Tensor, idx: torch.Tensor, g: int = PROBE_GATHERS
) -> torch.Tensor:
    """out[r, c] = sum over i < g, in order, of
    table[r, clip(idx[r, c] + i, 0, 127)]: the plain twin of the probe."""
    acc = torch.zeros_like(table)
    for i in range(g):
        cols = torch.clamp(idx + i, 0, LANE - 1).to(torch.int64)
        acc = acc + torch.take_along_dim(table, cols, dim=1)
    return acc


def gather_probe_cuda(
    table: torch.Tensor, idx: torch.Tensor, g: int = PROBE_GATHERS
) -> torch.Tensor:
    """The gather-roofline probe (``csrc/probe_gather.cu``), which replaces
    ``tools/probe_gather_roofline.py:bench_kernel``: ``g`` chained in-row
    gathers of each element from its table row, summed, a block a chunk of
    64 rows staged in shared memory. No path calls it; ``chip_smoke.py``
    measures the card's gather rate with it.

    Args:
      table: (R, 128) float32, contiguous.
      idx: (R, 128) int32, contiguous.

    On CUDA tensors this launches the kernel; on CPU tensors it runs
    ``gather_probe_plain``.
    """
    dev = table.device
    check_same_device(dev, idx=idx)
    check_tensor("table", table, torch.float32, ndim=2)
    check_tensor("idx", idx, torch.int32, shape=table.shape)
    if table.shape[1] != LANE:
        raise ValueError(f"table: {table.shape[1]} columns, expected {LANE}")
    if g < 0:
        raise ValueError(f"g must be >= 0, got {g}")
    if dev.type == "cpu":
        return gather_probe_plain(table, idx, g)
    if table.data_ptr() % 16:
        raise ValueError("table: the kernel stages rows with 16-byte loads; "
                         "its data must be 16-byte aligned")
    out = torch.empty_like(table)
    with torch.cuda.device(dev):
        KERNEL_PROBE(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     table.shape[0], g, stream_handle(dev))
    return out
