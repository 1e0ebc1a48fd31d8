"""Sequential demo: segment a scan sequence with adapted state (port of
``patchworkpp_tpu/cli/demo_sequential.py``).

Mirror of the reference demo (reference: python/examples/demo_sequential.py):
one engine instance, through the ``pypatchworkpp`` compat module, over the
scans in order, so the A-GLE thresholds and the sensor height adapt across
frames; prints per-frame counts and timing. The scans are the ``.bin``
files of ``data_dir`` (default ``$PPK_DATA_DIR``), else the six synthetic
64-beam scans. Open3D visualization is optional (``--visualize``).

Usage: python3 -m patchworkpp_tpu_torch.cli.demo_sequential [data_dir]
[--visualize] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from patchworkpp_tpu_torch.cli.workload import DATA_ENV, resolve_device, scan_cycle
from patchworkpp_tpu_torch.io import read_bin


def named_scans(data_dir, seed: int = 0, sub: int = 1):
    """(name, scan) pairs: the ``.bin`` files of ``data_dir`` in order, or
    the synthetic cycle when no directory is given."""
    if data_dir:
        names = sorted(f for f in os.listdir(data_dir) if f.endswith(".bin"))
        for name in names:
            yield name, read_bin(os.path.join(data_dir, name))[::sub]
    else:
        _, scans = scan_cycle(seed, sub)
        for i, s in enumerate(scans):
            yield f"synthetic {i}", s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", nargs="?", default=os.environ.get(DATA_ENV))
    ap.add_argument("--visualize", action="store_true")
    ap.add_argument("--sub", type=int, default=1, metavar="K",
                    help="keep every K-th point of each scan (a small run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from patchworkpp_tpu_torch.compat import pypatchworkpp

    params = pypatchworkpp.Parameters()
    params.verbose = False
    engine = pypatchworkpp.patchworkpp(params, device=str(resolve_device(args.device)))

    for name, cloud in named_scans(args.data_dir, args.seed, args.sub):
        engine.estimateGround(cloud)
        ground = engine.getGround()
        nonground = engine.getNonground()
        print(
            f"{name}: {len(cloud)} pts -> {len(ground)} ground / "
            f"{len(nonground)} nonground  "
            f"({engine.getTimeTaken() / 1000:.1f} ms, "
            f"sensor_height={engine.getHeight():.4f})"
        )
        if args.visualize:
            _visualize(ground, nonground, engine.getCenters(), engine.getNormals())
    return 0


def _visualize(
    ground: np.ndarray,
    nonground: np.ndarray,
    centers: np.ndarray,
    normals: np.ndarray,
) -> None:
    """Reference demo's per-frame scene (python/examples/demo_sequential.py
    :36-85): ground green, nonground red, patch centers yellow with plane
    normals, coordinate frame, H/N/ESC key callbacks."""
    try:
        import open3d as o3d
    except ImportError:
        print("open3d not installed; skipping visualization")
        return
    print("Press ...")
    print("\t H  : help")
    print("\t N  : visualize the surface normals")
    print("\tESC : close the Open3D window")
    g = o3d.geometry.PointCloud()
    g.points = o3d.utility.Vector3dVector(ground)
    g.paint_uniform_color([0.0, 1.0, 0.0])
    n = o3d.geometry.PointCloud()
    n.points = o3d.utility.Vector3dVector(nonground)
    n.paint_uniform_color([1.0, 0.0, 0.0])
    c = o3d.geometry.PointCloud()
    c.points = o3d.utility.Vector3dVector(centers)
    c.normals = o3d.utility.Vector3dVector(normals)
    c.paint_uniform_color([1.0, 1.0, 0.0])
    mesh = o3d.geometry.TriangleMesh.create_coordinate_frame()

    vis = o3d.visualization.VisualizerWithKeyCallback()
    vis.create_window(width=600, height=400)

    def _toggle_normals(v):
        opt = v.get_render_option()
        opt.point_show_normal = not opt.point_show_normal
        return False

    vis.register_key_callback(
        ord("H"),
        lambda v: print("H: help | N: toggle surface normals | ESC: close") or False,
    )
    vis.register_key_callback(ord("N"), _toggle_normals)
    vis.register_key_callback(256, lambda v: v.destroy_window() or False)
    for geom in (mesh, g, n, c):
        vis.add_geometry(geom)
    vis.run()
    vis.destroy_window()


if __name__ == "__main__":
    sys.exit(main())
