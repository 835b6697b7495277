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
fixed before the loop, or into tensors that only bodies of the same
decision read.

**Several cards.**  A process whose bands lie on several cards takes each
decision on every one of them: ``guard.gate({device: resid}, tol)`` gives
the iteration's ``Gate``, and ``gate(device, body)`` guards the compute
of ``device`` (captured on that device's ``body_stream``, allocating from
its ``body_pool``), as often as an iteration needs; the predicate of each
device is computed on it from its own copy of the residual, which every
card sums from the same joined block partials in the same order, so every
card takes the same branch with no predicate crossing between cards.
Cross-card copies and collectives stay at the top level of the graph,
between the IF nodes, so every card and every process launches the same
transfers in the same order whatever the tests decide.  On the host route
a decision that was read and does not hold is ``Gate.closed``: the
drivers then skip that iteration's transfers too, which every process
does alike, since each read the same bits.

``when(pred, body, tally)`` runs ``body()`` where the 0-dim bool ``pred``
holds, every time, with no latch: the counterpart of a ``lax.cond`` that
a loop meets again (the banded warp's reach test, parallel.sharded).
Under capture it is the same IF node; otherwise one host read of
``pred``, which it reports by returning True.  ``decide({device: pred})``
is its form over several cards.

A guard's ``tally`` is the int32 device scalar that counts its decisions
that held (the driver or a body adds to it).  Inside ``recording()`` every
body captured into an IF node appends to the list it yields (tally, its
place in its decision, the launches it added to each wrapper of
``ops.WRAPPERS``), so that a program can tell the launches under its IF
nodes, kind by kind, from those that every replay runs.
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
    inside the block, (its tally, its place in its decision, {wrapper
    name: launches the body added})."""
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


def capturing(device) -> bool:
    """Whether the current stream of ``device`` is being captured (False
    off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    with torch.cuda.device(device):
        return torch.cuda.is_current_stream_capturing()


class Gate:
    """One decision of a process, taken on each of its cards:
    ``gate(device, body)`` runs ``body()``, the compute of ``device``,
    where the decision holds.  Under capture each call is an IF node on
    that device's own predicate (``preds`` {device: 0-dim bool}, the same
    bits on every device); on the host route the decision was read once
    (``open``; ``read`` says whether that took a host read)."""

    def __init__(self, preds=None, tally=None, open_=False, read=False):
        self.preds, self.tally = preds, tally
        self.open, self.read = open_, read
        self.bodies = 0                 # IF nodes so far: each call's place in the decision

    @property
    def closed(self) -> bool:
        """Taken on the host and not holding: no body of the decision runs,
        so neither need the transfers that feed them (a capture keeps its
        fixed sequence of transfers)."""
        return self.preds is None and not self.open

    def __call__(self, device, body) -> None:
        if self.preds is None:
            if self.open:
                body()
            return
        device = torch.device(device)
        if device not in self.preds:
            raise ValueError(f"no predicate on {device}: the decision is held on "
                             f"{sorted(map(str, self.preds))}")
        _if_node(self.preds[device], body, self.tally, self.bodies)
        self.bodies += 1


def decide(preds: dict, tally=None) -> Gate:
    """The decision of ``preds`` {device: 0-dim bool, the same bits on every
    device}, with no latch (``when``'s): IF nodes under capture, else one
    host read of the first device's predicate."""
    first = next(iter(preds.values()))
    if capturing(first.device):
        return Gate({torch.device(d): p for d, p in preds.items()}, tally)
    return Gate(open_=bool(first), read=True)


class Guard:
    """The guard of one solve's iteration bodies; see the module docstring."""

    def __init__(self, owner, tally=None):
        self.owner = owner
        self.tally = tally
        self.stopped = False

    def gate(self, resids: dict, tol: float) -> Gate:
        """One iteration's decision, ``resid`` > ``tol``: ``resids``
        {device: 0-dim float32}, each device's copy of the residual (the
        same bits).  Under capture each device's predicate is computed on
        it; otherwise one host read of the first copy, none once a test has
        failed."""
        first = next(iter(resids.values()))
        if capturing(first.device):
            return Gate({torch.device(d): r > tol for d, r in resids.items()}, self.tally)
        if self.stopped:
            return Gate()
        self.owner.host_syncs += 1
        go = float(first) > tol
        self.stopped = not go
        return Gate(open_=go, read=True)

    def __call__(self, resid: torch.Tensor, tol: float, body) -> None:
        self.gate({resid.device: resid}, tol)(resid.device, body)


def when(pred: torch.Tensor, body, tally=None) -> bool:
    """``body()`` where the 0-dim bool ``pred`` holds, with no latch (see the
    module docstring); returns whether ``pred`` was read on the host."""
    gate = decide({pred.device: pred}, tally)
    gate(pred.device, body)
    return gate.read


def _if_node(pred: torch.Tensor, body, tally, index: int = 0) -> None:
    """Capture ``body()`` into an IF node on ``pred`` (a 0-dim bool) on the
    current stream of ``pred``'s device; ``index`` is the body's place in
    its decision (``Gate``), which files it with ``recording()``."""
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
                _bodies.append((tally, index, {name: n - before[name]
                                               for name, n in _launches().items()
                                               if n != before[name]}))
        finally:
            check_status(lib.octane_if_end(side.cuda_stream), "octane_if_end")
