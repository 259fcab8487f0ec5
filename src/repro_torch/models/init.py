"""Parameter draws for ``init_params`` from an explicit ``torch.Generator``.

``torch`` cannot redraw ``jax.random``, so the port's weights are its own
draws with the reference's shapes, dtypes (float32 masters) and scales;
``repro_torch.convert.params_from_reference`` carries the reference's
values over where two runs must compute the same thing. On the ``meta``
device the draws allocate nothing (``count_params``).

Given a ``dtype`` (the serving cells' bfloat16), each floating leaf is
stored in that dtype, drawn in float32 one slice of the layer axis at a
time: neither the float32 tree nor one whole float32 stacked leaf
exists, so a model whose float32 masters would not fit a card (moonshot-
v1-16b-a3b's 105.5 GiB) is drawn at its serving size. These are other
draws than the float32 default's: the slices' values differ from a cast
of the whole-leaf draw."""

from __future__ import annotations

import torch


class Draw:
    """Draws tensors of ``lead + shape`` on ``device`` from ``generator``,
    float32 unless ``dtype`` names the stored dtype (module docstring);
    ``stacked(n)`` prefixes a layer axis of size ``n`` (the reference's
    ``vmap``-stacked layer parameters)."""

    def __init__(self, generator: torch.Generator | None, device,
                 lead: tuple[int, ...] = (),
                 dtype: torch.dtype | None = None):
        self.generator = generator
        self.device = torch.device(device)
        self.lead = tuple(lead)
        self.dtype = dtype

    def stacked(self, n: int) -> "Draw":
        return Draw(self.generator, self.device, (n,) + self.lead,
                    self.dtype)

    def normal(self, shape, scale: float) -> torch.Tensor:
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.dtype or torch.float32,
                               device="meta")
        if self.dtype is None:
            return torch.randn(shape, generator=self.generator,
                               dtype=torch.float32,
                               device=self.device) * scale
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for part in (out if self.lead else out[None]):
            part.copy_(torch.randn(part.shape, generator=self.generator,
                                   dtype=torch.float32,
                                   device=self.device).mul_(scale))
        return out

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value,
                          dtype=self.dtype or torch.float32,
                          device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return self.full(shape, 1.0)

    def zeros(self, shape) -> torch.Tensor:
        return self.full(shape, 0.0)
