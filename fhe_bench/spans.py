"""CUDA-event spans around the program's gate batches and blind rotations,
recorded from outside (port.wrap_spans), for the traced run.

Each span is a pair of events on the current stream, so its time is the
device timeline's between the call's first and last launch, waits for the
host included.  Events are read once, after the window.  A rotation span
keeps its lane count and, for AP, its public input a2N, whose select bits
the roofline counts after the window.
"""

from __future__ import annotations

import torch

from . import port, roofline


class Spans:
    def __init__(self, method: str):
        self.method = method
        self.boot = []  # (start, end) events
        self.rot = []  # (start, end, lanes, a2N or None)
        self._restore = None

    def install(self) -> None:
        def boot_wrapper(orig):
            def bootstrap_batch(prep, gate_ids, keys, tp=None):
                e0, e1 = _event(), _event()
                e0.record()
                out = orig(prep, gate_ids, keys, tp)
                e1.record()
                self.boot.append((e0, e1))
                return out
            return bootstrap_batch

        def rot_wrapper(orig):
            def blind_rotation(acc, a2N, keys):
                e0, e1 = _event(), _event()
                e0.record()
                out = orig(acc, a2N, keys)
                e1.record()
                self.rot.append((e0, e1, acc.shape[0], a2N if self.method == "AP" else None))
                return out
            return blind_rotation

        self._restore = port.wrap_spans(boot_wrapper, rot_wrapper)

    def uninstall(self) -> None:
        if self._restore is not None:
            self._restore()
            self._restore = None

    def read(self, p: dict, d: int) -> dict:
        """Sums over the spans, in seconds, and the rotations' least time."""
        torch.cuda.synchronize()
        boot_s = sum(a.elapsed_time(b) for a, b in self.boot) / 1e3
        rot_s = sum(a.elapsed_time(b) for a, b, _, _ in self.rot) / 1e3
        least = 0.0
        for _, _, lanes, a2N in self.rot:
            if a2N is None:
                least += roofline.ginx_call(p, d, lanes)[0]
            else:
                pairs, steps = ap_live(a2N, p)
                least += roofline.ap_call(p, d, lanes, pairs, steps)[0]
        return dict(boot_s=boot_s, rot_s=rot_s, rot_least_s=least,
                    boot_calls=len(self.boot), rot_calls=len(self.rot))


def ap_live(a2N: torch.Tensor, p: dict) -> tuple[int, int]:
    """(selected (gate, step) pairs, steps that select any gate) of a
    binary-base AP rotation: step (i, j) selects gate b when bit j of
    (-a2N[b, i] mod 2N) is set."""
    two_n = 2 * p["N"]
    neg = (two_n - a2N.to(torch.int64)) % two_n
    j = torch.arange(roofline.ap_digits(p), device=a2N.device)
    bits = (neg[:, :, None] >> j) & 1  # [B, n, d_r]
    return int(bits.sum()), int(bits.any(0).sum())


def _event():
    return torch.cuda.Event(enable_timing=True)
