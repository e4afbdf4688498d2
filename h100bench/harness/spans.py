"""Device-time spans from CUDA events recorded around calls into the
program: forward hooks on a module, wrappers on a method, or ``begin`` and
``end`` called from any other hook. ``ms(name)`` gives each closed span's milliseconds,
after a synchronise."""

from __future__ import annotations

from typing import Dict, List

import torch


class Spans:
    def __init__(self):
        self.open: Dict[str, torch.cuda.Event] = {}
        self.done: Dict[str, list] = {}

    def begin(self, name: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.open[name] = e

    def end(self, name: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.done.setdefault(name, []).append((self.open.pop(name), e))

    def around_module(self, module: torch.nn.Module, name: str) -> None:
        module.register_forward_pre_hook(lambda m, a: self.begin(name))
        module.register_forward_hook(lambda m, a, o: self.end(name))

    def around_method(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            self.begin(name)
            out = inner(*args, **kwargs)
            self.end(name)
            return out

        setattr(obj, attr, wrapped)

    def ms(self, name: str) -> List[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.done.get(name, [])]

    def all_ms(self) -> Dict[str, List[float]]:
        return {k: self.ms(k) for k in self.done}
