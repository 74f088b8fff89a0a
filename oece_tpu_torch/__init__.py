"""oece_tpu_torch — the PyTorch/CUDA port of oece_tpu for NVIDIA Hopper.

The JAX package ``oece_tpu`` is the reference; this package grows beside it
with the same layout (``fhe/``, ``runtime/``) and never imports JAX.

Ported: the STD128_OPT verify-mode circuit path with either blind-rotation
method, GINX or binary-base AP (B_r = 2, as STD128 and STD128_OPT have it):
  fhe/modmath.py     int32 modular arithmetic
  fhe/keys.py        the key record (GINX rev2 diagonals or AP ap_ext limb
                     planes); converters from JAX keys and from NumPy
                     golden keys
  fhe/devkeygen.py   key generation on the device for both methods (sample
                     from eight named generator streams, then assemble)
  fhe/rot.py         the GINX rotation: a plain torch version and the
                     wrapper of the hand-written CUDA kernel
                     csrc/rot_step.cu (replaces the Pallas _rot_megakernel)
  fhe/ap.py          the AP rotation: a plain torch version and the wrapper
                     of the hand-written CUDA kernel csrc/ap_step.cu
                     (replaces the Pallas _ap_megakernel); both kernels
                     share the int8 matmul of csrc/int8_mm.cuh and are
                     built by fhe/_build.py with nvcc at first use
  fhe/boot.py        batched gate bootstrapping around the rotation
  fhe/lwe.py         device-side NOT, decryption and phase margin
  runtime/evaluator.py   ``Circuit`` in plaintext and verify modes

Reused unchanged from oece_tpu (none of them imports JAX):
  fhe.params, fhe.golden, the host encrypt_bits/decrypt_bits of fhe.lwe,
  circuits.{netlist, bristol, asm, lut, native, gen}, utils.trace,
  harness.models.

Deferred (ROADMAP.md queue 1): setRecovery and the automatic recovery of
pure-encrypted runs, compound XOR, DFF state, checkpointing, OECE_BAD_TRACE
lanes, device meshes, the generic-base AP method (B_r != 2),
fhe/context.py, fhe/ntt_dev.py, the key cache, and the TB command line and
testlib.  ``Circuit`` raises NotImplementedError for each feature it
reaches.

Device rule: every function takes its device from its tensors, and
``Circuit`` takes an explicit ``device``.  A kernel wrapper runs its plain
torch version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  Nothing falls back from the card to the CPU.
"""

__version__ = "0.1.0"
