"""Rescan pixel-reassignment scatter-add (reference component C6).

The rescanned line-STED engine accumulates each (re-binned) camera frame into
the output canvas at a per-frame column offset ``round((R-1) * x0)`` with
circular wrap (SURVEY.md section 4.3). The full-frame scan pipeline places
rounded offsets with this XLA scatter-add; duplicate canvas columns
accumulate.
"""

from __future__ import annotations

import jax.numpy as jnp


def rescan_accumulate_reference(
    canvas: jnp.ndarray, frames: jnp.ndarray, offsets: jnp.ndarray
) -> jnp.ndarray:
    """Scatter-add ``frames`` into ``canvas`` at per-frame column offsets.

    canvas: [H, Wc] f32; frames: [N, H, w] f32; offsets: [N] int32 column
    offsets (any integers; wrapped mod Wc). Returns the updated canvas.
    """
    n, h, w = frames.shape
    wc = canvas.shape[-1]
    cols = (offsets[:, None] + jnp.arange(w)[None, :]) % wc  # [N, w]
    # Scatter with duplicate indices accumulates.
    return canvas.at[:, cols].add(jnp.moveaxis(frames, 0, 1))
