"""Modality frontend stubs: [vlm]/[audio] archs get precomputed
patch/frame embeddings; the transformer backbone is real. The port's own
copy of the reference's ``src/repro/data/vision_stub.py`` (numpy only):
the same seeds give the same arrays.
"""
from __future__ import annotations

import numpy as np


def vision_stub_embeddings(batch: int, n_patches: int, d_model: int, seed: int = 0):
    """Stand-in for the Qwen2-VL vision tower's output (dynamic-resolution
    patch embeddings). Deterministic, unit-variance rows."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n_patches, d_model)).astype(np.float32) * (d_model ** -0.5)


def audio_frame_stub(batch: int, n_frames: int, d_model: int, seed: int = 0):
    """Stand-in for Whisper's conv1d+GELU frontend over log-mel frames
    (30 s -> 1500 frames)."""
    rng = np.random.default_rng(seed + 1)
    return rng.standard_normal((batch, n_frames, d_model)).astype(np.float32) * (d_model ** -0.5)
