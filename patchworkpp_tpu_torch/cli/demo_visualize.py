"""Single-scan demo (port of ``patchworkpp_tpu/cli/demo_visualize.py``,
the reference's python/examples/demo_visualize.py mirror).

Segments one scan through the port's ``pypatchworkpp`` compat module and
prints a summary, then either renders a headless PNG (``--save``;
matplotlib, no display needed) or, if Open3D is installed, opens its
window. The default scan is ``$PPK_DATA_DIR/000000.bin``; without it the
demo exits with a message. Runs on CUDA unless given ``--device cpu``.

Usage: python3 -m patchworkpp_tpu_torch.cli.demo_visualize [scan.bin]
[--save [out.png]] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from patchworkpp_tpu_torch.cli.workload import DATA_ENV, resolve_device
from patchworkpp_tpu_torch.compat import pypatchworkpp
from patchworkpp_tpu_torch.io import read_bin

# Reference demo color semantics (python/examples/demo_visualize.py:44-66):
# ground green, nonground red, patch centers/normals yellow.
_GROUND = (0.0, 0.8, 0.0)
_NONGROUND = (0.85, 0.1, 0.1)
_NORMALS = (0.75, 0.65, 0.0)


def save_png(engine, out_path: str, title: str = "") -> None:
    """Render ground/nonground + patch normals to a PNG, headless.

    Two panels: top-down (x, y) and side (x, z), subsampled for file size;
    normals drawn as short yellow segments at the patch centers (the
    reference visualizes them via Open3D point normals)."""
    try:
        import matplotlib
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "--save needs matplotlib (pip install matplotlib); the Open3D "
            "window path and the text summary do not"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    g = np.asarray(engine.getGround())
    n = np.asarray(engine.getNonground())
    c = np.asarray(engine.getCenters())
    nv = np.asarray(engine.getNormals())

    def _sub(a, k=3):
        return a[::k] if len(a) else a.reshape(0, 3)

    gs, ns = _sub(g), _sub(n)
    fig, axes = plt.subplots(
        2, 1, figsize=(10, 12.5),
        gridspec_kw={"height_ratios": [10, 2]}, constrained_layout=True,
    )
    views = (("top-down", 0, 1, "x [m]", "y [m]"),
             ("side", 0, 2, "x [m]", "z [m]"))
    for ax, (name, i, j, xl, yl) in zip(axes, views):
        ax.scatter(ns[:, i], ns[:, j], s=0.05, c=[_NONGROUND],
                   linewidths=0, label="nonground")
        ax.scatter(gs[:, i], gs[:, j], s=0.05, c=[_GROUND],
                   linewidths=0, label="ground")
        if len(c):
            scale = 2.0
            segs_x = np.stack([c[:, i], c[:, i] + scale * nv[:, i]], axis=1)
            segs_y = np.stack([c[:, j], c[:, j] + scale * nv[:, j]], axis=1)
            ax.plot(segs_x.T, segs_y.T, c=_NORMALS, lw=0.5, alpha=0.8)
        ax.set_title(f"{name}")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_aspect("equal")
        if name == "top-down":
            ax.set_xlim(-80, 80)
            ax.set_ylim(-80, 80)
        else:
            ax.set_xlim(-80, 80)
            ax.set_ylim(-4, 12)
        leg = ax.legend(loc="upper right", markerscale=40, fontsize=9)
        # matplotlib renamed legendHandles -> legend_handles in 3.7
        handles = getattr(leg, "legend_handles", None)
        if handles is None:
            handles = leg.legendHandles
        for h in handles:
            h.set_alpha(1.0)
    fig.suptitle(
        title
        or f"patchworkpp_tpu_torch — ground {len(g)} / nonground {len(n)} points",
        fontsize=12,
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    print(f"saved: {out_path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    data_dir = os.environ.get(DATA_ENV)
    ap.add_argument("scan", nargs="?",
                    default=os.path.join(data_dir, "000000.bin") if data_dir else None,
                    help=f"a KITTI .bin scan (default ${DATA_ENV}/000000.bin)")
    ap.add_argument(
        "--save", nargs="?", const="demo_000000.png", default=None, metavar="PNG",
        help="render a headless PNG instead of opening a window "
             "(default path: demo_000000.png)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.scan is None or not os.path.exists(args.scan):
        raise SystemExit(f"no scan at {args.scan}: pass a .bin file or set {DATA_ENV} "
                         "to a directory holding 000000.bin")
    cloud = read_bin(args.scan)

    dev = resolve_device(args.device)
    engine = pypatchworkpp.patchworkpp(pypatchworkpp.Parameters(), device=str(dev))
    engine.estimateGround(cloud)

    print(f"scan: {args.scan}")
    print(f"device: {dev}")
    print(f"points: {len(cloud)}")
    print(f"ground: {len(engine.getGroundIndices())}")
    print(f"nonground: {len(engine.getNongroundIndices())}")
    print(f"time: {engine.getTimeTaken() / 1000:.1f} ms")
    print(f"centers/normals of {len(engine.getCenters())} processed patches")

    if args.save:
        save_png(
            engine, args.save,
            title=(
                f"patchworkpp_tpu_torch demo — {os.path.basename(args.scan)}: "
                f"{len(engine.getGroundIndices())} ground / "
                f"{len(engine.getNongroundIndices())} nonground"
            ),
        )
        return 0

    try:
        import open3d as o3d
    except ImportError:
        return 0
    # Mirror the reference demo's scene and key bindings
    # (python/examples/demo_visualize.py:44-83): ground green, nonground
    # red, patch centers yellow carrying the plane normals, a coordinate
    # frame, and H (help) / N (toggle normals) / ESC (close) callbacks.
    print("Press ...")
    print("\t H  : help")
    print("\t N  : visualize the surface normals")
    print("\tESC : close the Open3D window")

    g = o3d.geometry.PointCloud()
    g.points = o3d.utility.Vector3dVector(engine.getGround())
    g.paint_uniform_color([0.0, 1.0, 0.0])
    n = o3d.geometry.PointCloud()
    n.points = o3d.utility.Vector3dVector(engine.getNonground())
    n.paint_uniform_color([1.0, 0.0, 0.0])
    centers = o3d.geometry.PointCloud()
    centers.points = o3d.utility.Vector3dVector(engine.getCenters())
    centers.normals = o3d.utility.Vector3dVector(engine.getNormals())
    centers.paint_uniform_color([1.0, 1.0, 0.0])
    mesh = o3d.geometry.TriangleMesh.create_coordinate_frame()

    vis = o3d.visualization.VisualizerWithKeyCallback()
    vis.create_window(width=600, height=400)

    def _toggle_normals(v):
        opt = v.get_render_option()
        opt.point_show_normal = not opt.point_show_normal
        return False

    def _close(v):
        v.destroy_window()
        return False

    def _help(v):
        print("H: help | N: toggle surface normals | ESC: close")
        return False

    vis.register_key_callback(ord("H"), _help)
    vis.register_key_callback(ord("N"), _toggle_normals)
    vis.register_key_callback(256, _close)  # GLFW_KEY_ESCAPE
    for geom in (mesh, g, n, centers):
        vis.add_geometry(geom)
    vis.run()
    vis.destroy_window()
    return 0


if __name__ == "__main__":
    sys.exit(main())
