"""Parameter draws for ``init_params`` from an explicit ``torch.Generator``.

``torch`` cannot redraw ``jax.random``, so the port's weights are its own
draws with the reference's shapes, dtypes (float32 masters) and scales;
``repro_torch.convert.params_from_reference`` carries the reference's
values over where two runs must compute the same thing. On the ``meta``
device the draws allocate nothing (``count_params``)."""

from __future__ import annotations

import torch


class Draw:
    """Draws float32 tensors of ``lead + shape`` on ``device`` from
    ``generator``; ``stacked(n)`` prefixes a layer axis of size ``n``
    (the reference's ``vmap``-stacked layer parameters)."""

    def __init__(self, generator: torch.Generator | None, device,
                 lead: tuple[int, ...] = ()):
        self.generator = generator
        self.device = torch.device(device)
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "Draw":
        return Draw(self.generator, self.device, (n,) + self.lead)

    def normal(self, shape, scale: float) -> torch.Tensor:
        shape = self.lead + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        return torch.randn(shape, generator=self.generator,
                           dtype=torch.float32, device=self.device) * scale

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value,
                          dtype=torch.float32, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return self.full(shape, 1.0)

    def zeros(self, shape) -> torch.Tensor:
        return self.full(shape, 0.0)
