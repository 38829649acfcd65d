"""Generation-3 relighting pipeline (my_rollingdepth_pipeline).

Counterpart of ``rollingdepth_tpu/pipelines/my_rollingdepth.py``: the
reference fork's third iteration shares generation 4's skeleton and
differs in four behaviours, each a ``RollingImgPipeline`` argument:

| gen-3 behaviour                                  | argument                          |
|--------------------------------------------------|-----------------------------------|
| one Gaussian init map repeated over the frames   | ``init_mode="shared_noise"``      |
| the empty prompt's embedding as the context      | ``empty_text=True``               |
| the full short schedule, no strength skip        | ``num_inference_steps`` 1, ``strength=1.0`` |
| UNet input ``[cond, latent]``, cond first        | ``cond_first=True``               |
"""

from __future__ import annotations

from .rollingimg import RollingImgOutput, RollingImgPipeline

__all__ = ["MyRollingDepthPipeline", "RollingImgOutput"]


class MyRollingDepthPipeline(RollingImgPipeline):
    """RollingImgPipeline with generation-3 defaults."""

    GEN3_DEFAULTS = dict(init_mode="shared_noise", empty_text=True, cond_first=True, strength=1.0)

    def __call__(self, *args, **kwargs) -> RollingImgOutput:
        merged = {**self.GEN3_DEFAULTS, **kwargs}
        merged.setdefault("num_inference_steps", 1)  # init_infer_steps=[1]
        return super().__call__(*args, **merged)

    def forward(self, *args, **kwargs) -> RollingImgOutput:
        merged = {**self.GEN3_DEFAULTS, **kwargs}
        merged.setdefault("num_inference_steps", 1)
        return super().forward(*args, **merged)
