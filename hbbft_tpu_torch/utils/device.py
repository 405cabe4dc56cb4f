"""Device choice and numeric pins for the port (the counterpart of the
JAX package's ``utils/jax_config.py``).

Every entry point of the port takes ``device=`` and defaults to the card
(``"cuda"``).  There is no fallback: a caller that wants the CPU names
it, and asking for the card on a machine without one raises instead of
quietly running somewhere else.

The field arithmetic relies on float32 products and sums being exact for
integers below 2^24.  TF32 keeps only a 10-bit mantissa, so both TF32
switches are pinned off here, at import, for every module of the port.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: the device every entry point uses unless the caller names another
DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """``device`` (or the default, the card) as a ``torch.device``.

    Raises when the card is asked for and CUDA is not available — the
    port never moves work to the CPU on its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
