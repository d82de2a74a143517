"""Self-contained interactive HTML report (reference component C15).

The reference's publication is a web page with figure panels the reader
drives with sliders (depletion power, scan position, view count). This
module rebuilds that artifact: every frame is simulated on the device
(one jitted program per figure), rendered to PNG on the host, base64-embedded
in ONE ``index.html`` with dependency-free vanilla-JS sliders -- the file
can be opened offline or dropped on any static host.

Figures:

1. **Dose-matched comparison** -- slider over depletion power s: point-STED,
   descanned line-STED, and rescanned line-STED at equal photodose.
2. **Scan process** -- slider over scan position: raw camera frame next to
   the accumulating descanned image (the reference's animated figure).
3. **Orientation fusion** -- slider over the number of fused views: RL
   fusion turns the anisotropic line-STED kernel isotropic.
4. **Resolution / signal tradeoff curves** (static panel).
"""

from __future__ import annotations

import base64
import io
import os

import jax
import jax.numpy as jnp
import numpy as np

from rescan_line_sted_tpu.algorithms import richardson_lucy_views
from rescan_line_sted_tpu.config import (
    Grid,
    LineSTEDGeometry,
    LineSTEDParams,
    PointSTEDGeometry,
    PointSTEDParams,
    RescanGeometry,
)
from rescan_line_sted_tpu.data import samples
from rescan_line_sted_tpu.imaging.frames import line_sted_camera_frames
from rescan_line_sted_tpu.imaging.line_sted import line_sted_image
from rescan_line_sted_tpu.imaging.orientations import (
    multi_orientation_line_sted,
)
from rescan_line_sted_tpu.sweeps import dose_matched_sweep
from rescan_line_sted_tpu.utils.observability import emit_metrics


def _png_b64(images: list[np.ndarray], titles: list[str],
             suptitle: str = "") -> str:
    """Render a row of images to a base64 PNG data URI."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.4))
    if n == 1:
        axes = [axes]
    for ax, img, title in zip(axes, images, titles):
        ax.imshow(np.asarray(img), cmap="magma")
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    if suptitle:
        fig.suptitle(suptitle, fontsize=10)
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=90)
    plt.close(fig)
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


def _curves_b64(powers, point_fx, line_fx, rescan_fx, psig, lsig,
                ism_fx=None, frc=None) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 3.6))
    ax1.plot(powers, point_fx, label="point STED (RL-restored)")
    ax1.plot(powers, line_fx, label="line STED (RL fused)")
    ax1.plot(powers, rescan_fx, "--", label="rescanned line STED (RL fused)")
    if ism_fx is not None:
        ax1.plot(powers, ism_fx, ":", label="rescanned point (ISM, RL)")
    if frc is not None:  # achieved-with-noise FRC resolutions (1/7)
        for name, curve in frc.items():
            ax1.plot(powers, curve, "x", ms=4, alpha=0.6,
                     label=f"{name} FRC (achieved)")
    ax1.set_xlabel("depletion power s"), ax1.set_ylabel("FWHM (px)")
    ax1.legend(fontsize=8), ax1.set_title("resolution at matched dose")
    ax2.plot(powers, psig, label="point")
    ax2.plot(powers, lsig, label="line")
    ax2.set_xlabel("depletion power s"), ax2.set_ylabel("emitted signal")
    ax2.legend(fontsize=8), ax2.set_title("signal at matched dose")
    fig.tight_layout()
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    plt.close(fig)
    return "data:image/png;base64," + base64.b64encode(
        buf.getvalue()).decode()


_SLIDER_JS = """
function wire(figId, frames, labelFmt) {
  const img = document.getElementById(figId + '-img');
  const slider = document.getElementById(figId + '-slider');
  const label = document.getElementById(figId + '-label');
  function update() {
    const i = parseInt(slider.value);
    img.src = frames[i];
    label.textContent = labelFmt(i);
  }
  slider.addEventListener('input', update);
  update();
}
"""


def _slider_figure(fig_id: str, caption: str, frames: list[str],
                   labels: list[str]) -> str:
    frames_js = ",".join(f'"{f}"' for f in frames)
    labels_js = ",".join(f'"{la}"' for la in labels)
    return f"""
<div class="figure">
  <img id="{fig_id}-img" alt="{fig_id}"/>
  <div class="controls">
    <input type="range" id="{fig_id}-slider" min="0"
           max="{len(frames) - 1}" value="0" step="1"/>
    <span id="{fig_id}-label"></span>
  </div>
  <p class="caption">{caption}</p>
  <script>
    (function() {{
      const frames = [{frames_js}];
      const labels = [{labels_js}];
      wire("{fig_id}", frames, i => labels[i]);
    }})();
  </script>
</div>
"""


def html_report(out_dir: str, size: int = 192, num_powers: int = 6,
                max_power: float = 16.0, dose_budget: float = 100.0,
                num_angles: int = 4, rl_iters: int = 30,
                scan_frames: int = 16, seed: int = 0) -> dict:
    """Generate the interactive publication report at ``out_dir/index.html``.

    Everything is simulated fresh at ``size``^2 (one jitted sweep + one
    jitted frame extraction + one jitted fusion), rendered, and embedded;
    the resulting HTML is fully self-contained.
    """
    os.makedirs(out_dir, exist_ok=True)
    grid = Grid(size, size)
    sample = samples.siemens_star((size, size))
    key = jax.random.key(seed)

    # --- figure 1 + 4: dose-matched sweep with rescan arm -----------------
    pgeom, lgeom = PointSTEDGeometry(grid), LineSTEDGeometry(grid)
    rgeom = RescanGeometry(grid, rescan_factor=2.0)
    pbase = PointSTEDParams.create(brightness=1.0)
    lbase = LineSTEDParams.create(brightness=1.0)
    powers = jnp.linspace(0.0, max_power, num_powers)
    # the paper's protocol: orientation-fused arms + RL-restored point arm,
    # so the published images AND the figure-4 curves are the fused results
    from rescan_line_sted_tpu.config import RescanPointGeometry

    igeom = RescanPointGeometry(grid, rescan_factor=2.0)
    sweep = jax.jit(lambda p, k: dose_matched_sweep(
        sample, pbase, lbase, pgeom, lgeom, p, dose_budget, key=k,
        orientations=2, rescan_geom=rgeom, fuse_orientations=True,
        fusion_iters=min(rl_iters, 30), ism_geom=igeom,
        frc=True))(powers, key)
    powers_np = np.asarray(powers)

    frames1, labels1 = [], []
    for i, s in enumerate(powers_np):
        frames1.append(_png_b64(
            [np.asarray(sweep.point.image[i]),
             np.asarray(sweep.line.image[i]),
             np.asarray(sweep.rescan.image[i]),
             np.asarray(sweep.ism.image[i])],
            ["point STED (RL-restored)", "line STED (2-orient. RL fused)",
             "rescanned line STED (RL fused)",
             "rescanned point (ISM, RL)"]))
        labels1.append(f"depletion power s = {s:.1f}")

    # --- figure 2: scan process (camera frame | accumulating image) -------
    aparams = LineSTEDParams.create(depletion=8.0, brightness=200.0)
    ageom = LineSTEDGeometry(grid, chunk=min(32, size))
    positions = jnp.linspace(0, size - 1, scan_frames).astype(jnp.int32)
    cams = np.asarray(line_sted_camera_frames(
        sample, aparams, ageom, positions, key=key))
    full = np.asarray(line_sted_image(sample, aparams, ageom, key=key).image)
    frames2, labels2 = [], []
    for i, x0 in enumerate(np.asarray(positions)):
        acc = np.zeros_like(full)
        acc[:, : int(x0) + 1] = full[:, : int(x0) + 1]
        frames2.append(_png_b64(
            [cams[i], acc], ["camera frame", "descanned image so far"]))
        labels2.append(f"scan position x0 = {int(x0)}")

    # --- figure 3: fusion vs number of orientations ------------------------
    angles = jnp.arange(num_angles) * (jnp.pi / num_angles)
    views, kernels = multi_orientation_line_sted(
        sample, aparams, ageom, angles, key=key)
    frames3, labels3 = [], []
    for k in range(1, num_angles + 1):
        fused = np.asarray(richardson_lucy_views(
            views[:k], kernels[:k], num_iter=rl_iters))
        frames3.append(_png_b64(
            [np.asarray(views[0]), fused],
            ["single view (anisotropic)", f"RL fusion of {k} view(s)"]))
        labels3.append(f"{k} orientation(s) fused")

    curves = _curves_b64(
        powers_np, np.asarray(sweep.point.fwhm_x),
        np.asarray(sweep.line.fwhm_x), np.asarray(sweep.rescan.fwhm_x),
        np.asarray(sweep.point.emitted_signal),
        np.asarray(sweep.line.emitted_signal),
        ism_fx=np.asarray(sweep.ism.fwhm_x),
        frc={"point": np.asarray(sweep.point.frc_resolution),
             "line": np.asarray(sweep.line.frc_resolution)})

    html = f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8"/>
<title>Rescanned line-STED simulation report</title>
<style>
 body {{ font-family: system-ui, sans-serif; max-width: 980px;
        margin: 2em auto; padding: 0 1em; color: #222; }}
 .figure {{ margin: 2.5em 0; }}
 .figure img {{ width: 100%; border: 1px solid #ddd; }}
 .controls {{ display: flex; gap: 1em; align-items: center; }}
 .controls input {{ flex: 1; }}
 .caption {{ font-size: 0.92em; color: #444; }}
 h1, h2 {{ color: #111; }}
</style>
<script>{_SLIDER_JS}</script>
</head><body>
<h1>Line-scanning vs point-scanning STED at matched photodose</h1>
<p>Interactive simulation report generated by
<code>rescan_line_sted_tpu</code> (JAX rebuild of the
rescan_line_sted simulation). Grid {size}&times;{size}, dose budget
{dose_budget:g} per pixel, Poisson shot noise; all images acquired at
dose-matched exposure.</p>

<h2>1. Dose-matched comparison</h2>
{_slider_figure("fig1", "Drag the slider to change the depletion power s. "
                "At equal total photodose the line-scanning modalities keep "
                "far more signal at high s because every pixel is "
                "illuminated W times fewer. The fourth panel is the "
                "beyond-reference rescanned POINT acquisition (2D pixel "
                "reassignment / ISM) at the point arm's dose.",
                frames1, labels1)}

<h2>2. The descanned line-STED scan process</h2>
{_slider_figure("fig2", "Raw camera frame at each scan position (left) and "
                "the descanned image accumulated so far (right).",
                frames2, labels2)}

<h2>3. Multi-orientation Richardson-Lucy fusion</h2>
{_slider_figure("fig3", "The line-STED kernel is STED-sharp only along the "
                "scan axis; fusing views scanned at different orientations "
                "restores isotropic resolution.", frames3, labels3)}

<h2>4. Resolution / signal tradeoff</h2>
<div class="figure"><img src="{curves}" alt="curves"/>
<p class="caption">Achieved (post-RL-fusion) point-response FWHM and
emitted signal vs depletion power at matched photodose. The x markers are
data-driven Fourier-Ring-Correlation resolutions (1/7 criterion) from two
independent noisy acquisitions -- the achieved-with-noise counterpart to
the kernel curves.</p></div>
</body></html>
"""
    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as f:
        f.write(html)

    metrics = {
        "pipeline": "html_report",
        "path": path,
        "bytes": os.path.getsize(path),
        "figures": 4,
        "frames": len(frames1) + len(frames2) + len(frames3) + 1,
    }
    emit_metrics({k: v for k, v in metrics.items() if k != "path"},
                 os.path.join(out_dir, "metrics.jsonl"))
    return metrics
