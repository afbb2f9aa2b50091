"""
The port's matplotlib debug visualisations (the counterpart of
gance_tpu/viz/): synthesis, overlay and reducer panels, the 3D waterfall,
the one-shot quick looks and the worked examples. Host-only, and imported
only when a debug output is asked for: nothing on the card's path imports
this package, so a host without matplotlib renders everything else.
"""

import matplotlib

matplotlib.use("Agg")

from gance_tpu_torch.viz.panels import (  # noqa: E402
    render_figure_to_rgb,
    synthesis_visualizer,
    vector_visualizer,
)
from gance_tpu_torch.viz.reduction_viz import visualize_result_layers  # noqa: E402
from gance_tpu_torch.viz.overlay_viz import (  # noqa: E402
    VisualizeOverlayThresholds,
    visualize_overlay_computation,
)

__all__ = [
    "render_figure_to_rgb",
    "synthesis_visualizer",
    "vector_visualizer",
    "visualize_result_layers",
    "visualize_overlay_computation",
    "VisualizeOverlayThresholds",
]
