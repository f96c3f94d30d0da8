from repro_torch.core.spectral import (
    SPECTRAL_KEYS,
    is_spectral,
    spectral_apply,
    spectral_init,
)

__all__ = ["SPECTRAL_KEYS", "is_spectral", "spectral_apply", "spectral_init"]
