"""The render-function registry (counterpart of
``skelsplat_tpu/renderer_registry.py``).

The reference picks one of three render functions by the
``pipeline.rendering`` config key, each bound to a CUDA package compiled
for one channel count. Here one dense renderer (``ops/rasterizer.render``)
serves all three; the registry keeps the config-driven API, the
reference's call signature and its output dict.
"""

from __future__ import annotations

import torch

from skelsplat_tpu_torch.ops import rasterizer

# pipeline.rendering config keys → channel counts
RENDERING_CHANNELS = {
    "diff-gaussian-rasterization-h36m": 17,
    "diff-gaussian-rasterization-panoptic": 19,
    "diff-gaussian-rasterization-op": 15,
}


def _make_render(n_channels: int):
    def render_fn(viewpoint_camera, pc, pipe=None, bg_color=None,
                  scaling_modifier=1.0, separate_sh=False,
                  override_color=None, use_trained_exp=False):
        """Render ``pc`` (``GaussianParams`` or ``compat.GaussianModel``)
        from one ``Camera``; ``override_color`` (N,C) replaces the one-hot
        features. The reference adds no background, so ``bg_color`` is
        accepted and ignored. Returns the reference's output dict."""
        params = getattr(pc, "params", pc)
        n = params.n_joints
        if n != n_channels:
            raise ValueError(
                f"renderer expects {n_channels} channels, model has {n} "
                "joints (pipeline.rendering mismatch)")
        W = int(viewpoint_camera.width)
        H = int(viewpoint_camera.height)
        antialiasing = bool(getattr(pipe, "antialiasing", False))
        out = rasterizer.render(params, viewpoint_camera, W, H,
                                scaling_modifier=scaling_modifier,
                                antialiasing=antialiasing,
                                features=override_color)
        return {
            "render": out["render"],
            "viewspace_points": torch.zeros((n, 3), device=params.xyz.device),
            "visibility_filter": out["visibility_filter"],
            "radii": out["radii"],
            "depth": out["depth"],
        }

    render_fn.__name__ = f"render_{n_channels}ch"
    return render_fn


render_h36m = _make_render(17)
render_panoptic = _make_render(19)
render_op = _make_render(15)

render_functions = {
    "diff-gaussian-rasterization-h36m": render_h36m,
    "diff-gaussian-rasterization-panoptic": render_panoptic,
    "diff-gaussian-rasterization-op": render_op,
}
