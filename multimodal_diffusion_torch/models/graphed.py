"""Captured CUDA graphs of the AV model's denoiser forward
(``AVDiffusionModel.denoise_tokens``).

A sampler calls the denoiser with the same shapes at every step, and at the
sizes the port samples, issuing its few hundred launches one at a time from
Python takes longer than the card takes to run them. ``DenoiserGraphs``
captures a call once per static key as a ``torch.cuda.CUDAGraph`` and
replays it for the calls after. The graph holds the same launches as the
eager call, the hand-written kernels among them, at the same dtypes.

  * ``ineligible`` names why a call runs eagerly: a model in training
    mode, grad enabled, dense attention forced (``ops/attention.py::
    attention_path``), a core layout over several ranks, or operands off
    CUDA. Every other call takes a graph;
  * the key (``DenoiserGraphs.key``): each tensor argument's shape, dtype and
    device (None for an absent one), the token grids, whether inference mode
    is on, and each parameter's storage address and version counter, so an
    in-place update or ``load_state_dict`` makes a new key; the old weights'
    graph of the same shapes is dropped then;
  * a key's first call runs eagerly on the stream that captures (the warm-up
    a capture needs: cuBLAS workspaces, kernel attributes), its second is
    captured there and replayed, and the calls after replay: the tensor
    arguments are copied into the graph's static inputs and every output is
    handed back as a fresh clone, so a caller that keeps one pass's output
    across passes reads what it was given;
  * at most ``MAX_KEYS`` keys are kept, the least recently used dropped
    first; a dropped graph's memory pool goes with it.

Captures run in ``thread_local`` mode: the serving runner's finalizer
threads copy results to the host while its scheduler thread may be
capturing. A capture runs in the span ``denoiser.capture`` and a replay
(copies in, the graph, clones out) in ``denoiser.replay``
(``utils/profiling.py::span``). ``ops/cuda_kernels.py::LAUNCHES`` keeps
counting kernel executions, whichever kernels the call launches: what a
capture counts is taken back, and each replay adds it again.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from ..ops import cuda_kernels as ck
from ..ops.attention import forced_path
from ..utils.profiling import span

MAX_KEYS = 4  # the serving runner's batch shapes fit


def ineligible(model, tensors: Dict[str, Optional[torch.Tensor]]) -> Optional[str]:
    """Why a ``denoise_tokens`` call of `model` on `tensors` runs eagerly,
    or None when it takes a graph."""
    L = model.core.layout
    if model.training:
        return "training mode"
    if torch.is_grad_enabled():
        return "grad enabled"
    if forced_path() == "dense":
        return "dense attention"
    if (L.tp_n, L.ctx_n, L.pipe_n) != (1, 1, 1):
        return "core layout over several ranks"
    if not all(t.is_cuda for t in tensors.values() if t is not None):
        return "operands off CUDA"
    return None


class CapturedCall:
    """One captured call: the graph, its static inputs and outputs, and the
    kernel launches it makes, by kernel."""

    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Dict[str, Optional[torch.Tensor]],
                 outputs: Dict[str, torch.Tensor], launches: "collections.Counter[str]"):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches = launches

    def replay(self, tensors: Dict[str, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
        for name, t in tensors.items():
            if t is not None:
                self.inputs[name].copy_(t)
        self.graph.replay()
        ck.LAUNCHES.update(self.launches)
        return {name: t.clone() for name, t in self.outputs.items()}


class DenoiserGraphs:
    """The graphs of one model's denoiser calls, by key (module docstring)."""

    def __init__(self):
        # key -> its CapturedCall, or None once the key's warm-up has run
        self.calls: "collections.OrderedDict[Tuple, Optional[CapturedCall]]" = \
            collections.OrderedDict()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self._children: Optional[Tuple] = None
        self._holders: list = []  # the model's modules that hold parameters

    # a copy of the model (deepcopy, pickle) starts with no graphs
    def __getstate__(self):
        return {}

    def __setstate__(self, state):
        self.__init__()

    def weights(self, model: torch.nn.Module) -> Tuple:
        """(storage address, version counter) of each parameter of `model`:
        a parameter replaced (``load_state_dict(assign=True)``), re-pointed
        (``p.data = ...``) or updated in place reads differently. The modules
        are gathered again when the model's children change."""
        children = tuple(map(id, model.children()))
        if children != self._children:
            self._children = children
            self._holders = [m for m in model.modules() if m._parameters]
        return tuple([(p.data_ptr(), p._version) for m in self._holders
                      for p in m._parameters.values() if p is not None])

    def key(self, model: torch.nn.Module, tensors: Dict[str, Optional[torch.Tensor]],
            statics: Hashable) -> Tuple:
        """(what fixes the graph's shapes, the weights' state)."""
        shapes = tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                       for t in tensors.values())
        return (shapes, statics, torch.is_inference_mode_enabled()), self.weights(model)

    def __call__(self, model: torch.nn.Module, fn: Callable[..., Dict[str, torch.Tensor]],
                 tensors: Dict[str, Optional[torch.Tensor]], statics: Hashable
                 ) -> Dict[str, torch.Tensor]:
        """``fn(**tensors)`` through the graph of its key: eagerly on the
        key's first call, captured on its second, replayed after."""
        key = self.key(model, tensors, statics)
        if key not in self.calls:
            self._admit(key)
            return self._warm_up(fn, tensors)
        self.calls.move_to_end(key)
        call = self.calls[key]
        if call is None:
            with span("denoiser.capture"):
                call = self.calls[key] = self._capture(fn, tensors)
        with span("denoiser.replay"):
            return call.replay(tensors)

    def _admit(self, key: Tuple) -> None:
        """Make room for `key`: drop the graph of its shapes under older
        weights, then the least recently used beyond ``MAX_KEYS``."""
        for old in [k for k in self.calls if k[0] == key[0]]:
            del self.calls[old]
        self.calls[key] = None
        while len(self.calls) > MAX_KEYS:
            self.calls.popitem(last=False)

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    @staticmethod
    def _device(tensors: Dict[str, Optional[torch.Tensor]]) -> torch.device:
        return next(t.device for t in tensors.values() if t is not None)

    def _warm_up(self, fn, tensors):
        device = self._device(tensors)
        side, main = self._stream(device), torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(**tensors)
        main.wait_stream(side)
        return out

    def _capture(self, fn, tensors) -> CapturedCall:
        device = self._device(tensors)
        inputs = {name: None if t is None else t.clone(memory_format=torch.contiguous_format)
                  for name, t in tensors.items()}
        graph = torch.cuda.CUDAGraph()
        before = ck.LAUNCHES.copy()
        with torch.cuda.graph(graph, stream=self._stream(device),
                              capture_error_mode="thread_local"):
            outputs = fn(**inputs)
        launches = ck.LAUNCHES - before
        ck.LAUNCHES.subtract(launches)
        return CapturedCall(graph, inputs, outputs, launches)
