"""Guarded iteration bodies: the relaxers' stopping tests on the device.

``Guard(owner, tally)`` guards the iteration bodies of one solve.
``guard(resid, tol, body)`` runs ``body()`` while the 0-dim float32 tensor
``resid`` exceeds ``tol``, the counterpart of the condition of the JAX
package's ``lax.while_loop`` (octane_tpu/ops/pallas/cg.py:306-320) and of
the ``lax.cond`` of its SOR remainder pass (ops/pallas/sor.py:523-525):

* while a CUDA graph is being captured on the current stream, ``body`` is
  captured into the body of a graph IF node (``csrc/graph.cu``), whose
  condition a one-thread kernel sets from ``resid > tol`` at every replay:
  no host read.  The body is captured on a stream of its own
  (``body_stream``), and its allocations come from a memory pool of its
  own (``body_pool``) that lives as long as the module, so a graph's
  temporaries are never handed to other code;
* otherwise ``resid`` is read on the host (``owner.host_syncs`` counts the
  reads) and ``body`` runs when it exceeds ``tol``.  After the first body
  the test skips, the later ones are skipped unread: nothing updates the
  residual any more, as on the device.

The drivers (ops.pcg.pcg_solve_fused, ops.sor.sor_solve_cf and the banded
parallel.sor / parallel.cg ``solve_bands``) call the guard once per
iteration and never break out of their loops, so the host route walks the
same guarded bodies as the captured one.  A body writes only into buffers
fixed before the loop.

``when(pred, body, tally)`` runs ``body()`` where the 0-dim bool ``pred``
holds, every time, with no latch: the counterpart of a ``lax.cond`` that
a loop meets again (the banded warp's reach test, parallel.sharded).
Under capture it is the same IF node; otherwise one host read of
``pred``, which it reports by returning True.

A guard's ``tally`` is the int32 device scalar that counts its bodies that
ran (the driver or the body adds to it).  Inside ``recording()`` every body
captured into an IF node appends to the list it yields (tally, the launches
it added to each wrapper of ``ops.WRAPPERS``), so that a program can tell
the launches under its IF nodes, kind by kind, from those that every
replay runs.
"""

from __future__ import annotations

import contextlib

import torch

from octane_tpu_torch.ops.build import check_status, load_kernels

_streams: dict = {}
_pools: dict = {}
_bodies = None          # the list of recording(), while it is open


@contextlib.contextmanager
def recording():
    """Yield a list that gains, for each body captured into an IF node
    inside the block, (its tally, {wrapper name: launches the body
    added})."""
    global _bodies
    outer, _bodies = _bodies, []
    try:
        yield _bodies
    finally:
        _bodies = outer


def _launches() -> dict:
    from octane_tpu_torch.ops import WRAPPERS

    return {name: fn.launches for name, fn in WRAPPERS.items()}


def body_stream(device) -> torch.cuda.Stream:
    """The stream that IF-node bodies on ``device`` are captured on."""
    device = torch.device(device)
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def body_pool(device):
    """The memory pool of the IF-node bodies captured on ``device``."""
    device = torch.device(device)
    if device not in _pools:
        with torch.cuda.device(device):
            _pools[device] = torch.cuda.MemPool()
    return _pools[device]


class Guard:
    """The guard of one solve's iteration bodies; see the module docstring."""

    def __init__(self, owner, tally=None):
        self.owner = owner
        self.tally = tally
        self.stopped = False

    def __call__(self, resid: torch.Tensor, tol: float, body) -> None:
        if resid.is_cuda and torch.cuda.is_current_stream_capturing():
            _if_node(resid > tol, body, self.tally)
            return
        if self.stopped:
            return
        self.owner.host_syncs += 1
        if float(resid) > tol:
            body()
        else:
            self.stopped = True


def when(pred: torch.Tensor, body, tally=None) -> bool:
    """``body()`` where the 0-dim bool ``pred`` holds, with no latch (see the
    module docstring); returns whether ``pred`` was read on the host."""
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        _if_node(pred, body, tally)
        return False
    if bool(pred):
        body()
    return True


def _if_node(pred: torch.Tensor, body, tally) -> None:
    """Capture ``body()`` into an IF node on ``pred`` (a 0-dim bool)."""
    lib = load_kernels()
    dev = pred.device
    stream = torch.cuda.current_stream(dev)
    side = body_stream(dev)
    with torch.cuda.device(dev):
        check_status(lib.octane_if_begin(stream.cuda_stream, pred.data_ptr(),
                                         side.cuda_stream), "octane_if_begin")
        try:
            before = _launches()
            with torch.cuda.stream(side), torch.cuda.use_mem_pool(body_pool(dev)):
                body()
            if _bodies is not None:
                _bodies.append((tally, {name: n - before[name]
                                        for name, n in _launches().items()
                                        if n != before[name]}))
        finally:
            check_status(lib.octane_if_end(side.cuda_stream), "octane_if_end")
