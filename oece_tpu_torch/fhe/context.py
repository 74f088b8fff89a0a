"""BinFHEContext: the OpenFHE ``binfhe`` surface on torch (counterpart of
oece_tpu.fhe.context).

The reference programs use exactly this interface: GenerateBinFHEContext,
KeyGen, BTKeyGen, Encrypt, Decrypt, EvalBinGate and EvalNOT, plus the batch
calls.  Randomness and the boundary types follow the JAX package's class:
one ``np.random.Generator`` (seeded by ``GenerateBinFHEContext``) draws the
LWE secret, the bootstrap keys in golden's order and every encryption, so
one seed gives the JAX context's keys and ciphertexts bit for bit.
Ciphertexts are numpy int32 [n+1] in and out of the single calls;
``EvalBinGateBatch`` returns a tensor on the context's device (JAX returns
a device array) and takes numpy arrays or tensors, so batches chain on the
card.

The keys are golden's host keys, packed as the JAX package packs them on
an accelerator: GINX keys as ``ginx_ext`` (the standard-form rotation of
fhe/std.py, Pallas kernels #1 and #4), AP keys as ``ap_ext`` (fhe/ap.py:
kernel #13 for the binary base, B_r = 2; every digit value and the
torch-ops rotation ``blind_rotate_ap_generic`` for a generic base, as
MICRO and TOY have it).  The ring products of key generation
run on the device (fhe/hostkeygen.py).  ``device`` defaults to "cuda";
"cpu" runs every kernel's plain torch version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import _build, boot, golden, hostkeygen, lwe
from .keys import GATE_INDEX, BootKeys
from .params import BinFHEMethod, BinFHEParams, BinGate, get_params


class BinFHEContext:
    """OpenFHE-style context owning parameters and, after BTKeyGen, the
    bootstrap keys on ``device``."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("BinFHEContext(device='cuda'): CUDA is not available")
            _build.load()  # build the kernels now; raises on failure
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.params: Optional[BinFHEParams] = None
        self.method: BinFHEMethod = BinFHEMethod.GINX
        self._rng = np.random.default_rng()
        self.keys: Optional[BootKeys] = None

    # -- context/keys -------------------------------------------------------
    def GenerateBinFHEContext(
        self,
        set: str | BinFHEParams = "STD128_OPT",
        method: str | BinFHEMethod = "GINX",
        seed: Optional[int] = None,
    ) -> "BinFHEContext":
        self.params = get_params(set) if isinstance(set, str) else set
        if not isinstance(self.params, BinFHEParams):
            raise TypeError(f"want a parameter set name or the port's BinFHEParams, got {set!r}")
        self.method = (
            method if isinstance(method, BinFHEMethod) else BinFHEMethod[str(method).upper()]
        )
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        return self

    def KeyGen(self) -> golden.LWESecretKey:
        assert self.params is not None, "GenerateBinFHEContext first"
        return golden.lwe_keygen(self.params, self._rng)

    def BTKeyGen(self, sk: golden.LWESecretKey) -> None:
        self.keys = hostkeygen.bootstrap_keygen(self.params, sk, self._rng, self.method, self.device)

    # -- encryption boundary ------------------------------------------------
    def Encrypt(self, sk: golden.LWESecretKey, m: int) -> np.ndarray:
        return lwe.encrypt_bits(sk, np.array([int(m)]), self._rng)[0]

    def Decrypt(self, sk: golden.LWESecretKey, ct) -> int:
        return int(self.DecryptBatch(sk, _host(ct)[None, :])[0])

    def EncryptBatch(self, sk: golden.LWESecretKey, bits: Sequence[int]) -> np.ndarray:
        return lwe.encrypt_bits(sk, np.asarray(bits), self._rng)

    def DecryptBatch(self, sk: golden.LWESecretKey, cts) -> np.ndarray:
        return lwe.decrypt_bits(sk, _host(cts))

    # -- gates --------------------------------------------------------------
    def EvalNOT(self, ct: np.ndarray) -> np.ndarray:
        cts = torch.as_tensor(np.asarray(ct, dtype=np.int32)[None, :])
        return lwe.eval_not_batch(cts, self.params.q).numpy()[0]

    def EvalBinGate(self, gate: str | BinGate, ct1: np.ndarray, ct2: np.ndarray) -> np.ndarray:
        out = self.EvalBinGateBatch(gate, np.asarray(ct1)[None, :], np.asarray(ct2)[None, :])
        return out.cpu().numpy()[0]

    def EvalBinGateBatch(self, gate, ct1, ct2) -> torch.Tensor:
        """One bootstrap per row of ct1/ct2 [B, n+1]; ``gate`` is one gate
        (name or BinGate) for every row, or a sequence of them."""
        assert self.keys is not None, "BTKeyGen first"
        c1, c2 = self._on_device(ct1), self._on_device(ct2)
        B = c1.shape[0]
        if isinstance(gate, (str, BinGate)):
            gids = [GATE_INDEX[_gate(gate)]] * B
        else:
            gids = [GATE_INDEX[_gate(g)] for g in gate]
        gids = torch.tensor(gids, dtype=torch.int32, device=self.device)
        return boot.eval_bin_gate_batch(self.keys, gids, c1, c2)

    def _on_device(self, cts) -> torch.Tensor:
        if not isinstance(cts, torch.Tensor):
            cts = torch.from_numpy(np.asarray(cts, dtype=np.int32))
        return cts.to(self.device, torch.int32)


def _gate(g: str | BinGate) -> BinGate:
    """A gate by name or BinGate member."""
    return g if isinstance(g, BinGate) else BinGate[g]


def _host(cts) -> np.ndarray:
    return cts.cpu().numpy() if isinstance(cts, torch.Tensor) else np.asarray(cts)
