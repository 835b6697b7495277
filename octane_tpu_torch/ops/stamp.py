"""The tracer's clock stamp: CUDA kernel and plain version.

``stamp(buf, slot)`` writes a clock in nanoseconds into ``buf[slot]`` of a
1-D int64 buffer.  On a CUDA tensor it launches ``csrc/stamp.cu`` on the
current stream, which stores the card's ``%globaltimer`` when the work
before it on the stream has run (a kernel node where a graph is being
captured); on a CPU tensor it stores ``time.perf_counter_ns()`` at once.
``stamp.launches`` / ``.plain_calls`` count them.  ``utils.profiling``
calls it, only while tracing is on, and turns the card's times into the
host clock's.  ``launch(buf, slot)`` is the kernel's launch alone,
uncounted, for the tracer's clock offset.
"""

from __future__ import annotations

import time

import torch

from octane_tpu_torch.ops.build import check_status, load_kernels


def _check(buf: torch.Tensor, slot: int) -> None:
    if buf.dtype != torch.int64 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError(f"stamp: expected a contiguous 1-D int64 buffer, got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    if not 0 <= slot < buf.numel():
        raise ValueError(f"stamp: slot {slot} outside a buffer of {buf.numel()}")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stamp: unsupported device {buf.device}")


def launch(buf: torch.Tensor, slot: int) -> None:
    """The kernel on a CUDA ``buf``, not counted."""
    lib = load_kernels()
    with torch.cuda.device(buf.device):
        status = lib.octane_stamp(buf.data_ptr(), slot,
                                  torch.cuda.current_stream(buf.device).cuda_stream)
    check_status(status, "octane_stamp")


def stamp(buf: torch.Tensor, slot: int) -> None:
    """Write the clock (ns) into ``buf[slot]``; see the module docstring."""
    _check(buf, slot)
    if buf.device.type == "cpu":
        stamp.plain_calls += 1
        buf[slot] = time.perf_counter_ns()
        return
    launch(buf, slot)
    stamp.launches += 1


stamp.launches = 0
stamp.plain_calls = 0
