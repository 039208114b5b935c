"""Block-local row gather: CUDA kernel, its plain PyTorch version, and the
wrapper that picks between them.

Replaces the Pallas TPU kernel of the JAX package's
``script/bench_tile_gather.py`` ``pallas_gather_probe``, the row-gather
probe of that microbenchmark:

    out[b * P + p, :] = src[b * V + idx[b * P + p], :]

for blocks b of V = P = ``block_rows`` rows of 128 bf16 values. The kernel
is ``csrc/row_gather.cu``; its bound on the H100 is bytes (the output, the
indices and each distinct source row, once).

``block_row_gather`` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. There is no autograd (the
probe has none). ``block_row_gather.launches`` counts kernel launches.
Indices must lie in [0, block_rows): the plain version raises on others,
the kernel clamps them into the block.
"""
from __future__ import annotations

import torch

from . import cuda_build

ROW_WIDTH = 128          # bf16 values per row: 256 bytes
BLOCK_ROWS = 4096        # V = P of the probe


def _blocks(src: torch.Tensor, idx: torch.Tensor, block_rows: int) -> int:
    if src.dim() != 2 or src.shape[1] != ROW_WIDTH or idx.dim() != 1:
        raise ValueError(f"block_row_gather takes src (rows, {ROW_WIDTH}) and 1-D idx, "
                         f"got {tuple(src.shape)} and {tuple(idx.shape)}")
    if block_rows <= 0 or src.shape[0] % block_rows or idx.shape[0] != src.shape[0]:
        raise ValueError(f"block_row_gather takes whole blocks of {block_rows} rows "
                         f"and one index per source row, got {src.shape[0]} rows "
                         f"and {idx.shape[0]} indices")
    return src.shape[0] // block_rows


def block_row_gather_reference(src: torch.Tensor, idx: torch.Tensor,
                               block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Plain PyTorch version: per block, ``torch.gather`` of the index
    broadcast across the row, as the Pallas body's ``take_along_axis``.
    src (n_blocks * block_rows, 128), idx (n_blocks * block_rows,) ->
    (n_blocks * block_rows, 128)."""
    n_blocks = _blocks(src, idx, block_rows)
    s = src.reshape(n_blocks, block_rows, ROW_WIDTH)
    i = idx.long().reshape(n_blocks, block_rows, 1).expand(-1, -1, ROW_WIDTH)
    return torch.gather(s, 1, i).reshape(-1, ROW_WIDTH)


def bytes_moved(idx: torch.Tensor, block_rows: int = BLOCK_ROWS,
                row_bytes: int = 2 * ROW_WIDTH) -> int:
    """The bytes the gather must move for these indices: every output row
    written once, every index read once and every distinct source row
    read once."""
    n_blocks = idx.numel() // block_rows
    block = torch.arange(n_blocks, device=idx.device).repeat_interleave(block_rows)
    distinct = torch.unique(block * block_rows + idx.long()).numel()
    return idx.numel() * (row_bytes + idx.element_size()) + distinct * row_bytes


def _launch(src: torch.Tensor, idx: torch.Tensor, block_rows: int) -> torch.Tensor:
    _blocks(src, idx, block_rows)
    if not (src.is_cuda and idx.device == src.device and src.dtype == torch.bfloat16
            and idx.dtype == torch.int32):
        raise ValueError("row_gather kernel takes bfloat16 src and int32 idx on one "
                         f"CUDA device, got {src.dtype} on {src.device} and "
                         f"{idx.dtype} on {idx.device}")
    ext = cuda_build.extension()
    if ext.row_gather_row_bytes() != ROW_WIDTH * src.element_size():
        raise ValueError("row_gather row width does not match the kernel")
    src, idx = src.contiguous(), idx.contiguous()
    out = torch.empty_like(src)
    with torch.cuda.device(src.device):
        ext.row_gather(src, idx, out, block_rows)
    block_row_gather.launches += 1
    return out


def block_row_gather(src: torch.Tensor, idx: torch.Tensor,
                     block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Block-local row gather: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not src.is_cuda:
        return block_row_gather_reference(src, idx, block_rows)
    return _launch(src, idx, block_rows)


block_row_gather.launches = 0
