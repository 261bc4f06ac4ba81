"""Why the chunked route's products run in 3xTF32: the error of its
decomposition (:func:`.ref.wkv_two_phase_ref`) with plain TF32 and with
3xTF32 products against the float32 plain version, on the CPU.

    python -m repro_torch.kernels.wkv6.precision
"""

from __future__ import annotations

import numpy as np
import torch

from .ref import wkv_chunked_ref, wkv_two_phase_ref


def _rel_l2(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def main() -> None:
    """Relative L2 error of :func:`.ref.wkv_two_phase_ref` with plain TF32 and
    with 3xTF32 products against :func:`.ref.wkv_chunked_ref` (float32), at
    B = 2, L = 256, H = 4, N = 64, chunk 32, on numpy-seeded inputs made as
    the tests make them (decay scale 2.0 and 3.5)."""
    for scale in (2.0, 3.5):
        rng = np.random.default_rng(0)
        shape = (2, 256, 4, 64)
        r, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for _ in range(3))
        w = torch.from_numpy(np.exp(-np.exp(rng.standard_normal(shape) * scale))
                             .astype(np.float32))
        u = torch.from_numpy((0.1 * rng.standard_normal((4, 64))).astype(np.float32))
        s0 = torch.from_numpy((0.2 * rng.standard_normal((2, 4, 64, 64)))
                              .astype(np.float32))
        y_ref, s_ref = wkv_chunked_ref(r, k, v, w, u, s0, chunk=32)
        for passes in (1, 3):
            y, s = wkv_two_phase_ref(r, k, v, w, u, s0, chunk=32, passes=passes)
            print(f"scale {scale} {'3xTF32' if passes == 3 else 'TF32  '}: "
                  f"y relative L2 {_rel_l2(y, y_ref):.3e}, "
                  f"s_final relative L2 {_rel_l2(s, s_ref):.3e}")


if __name__ == "__main__":
    main()
