"""Render demo frames to PNG with the PyTorch port: the visual smoke test.

The counterpart of tools/demo.py, with the same flags.  It runs on the CUDA
device; --cpu renders on the CPU instead (the kernels' plain versions).
It checks the first frame for capacity overflow through render_stats, then
drives runtime.App with save_frames_to_dir.

Usage:
    python tools/demo_torch.py [--scene reference|benchmark] [--frames 8] [--out DIR]
                               [--width 1280] [--height 720] [--shading lambert|pbr]
                               [--lights N] [--cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="reference", choices=["reference", "benchmark"])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "build", "frames"))
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--shading", default="lambert", choices=["lambert", "pbr"])
    ap.add_argument("--lights", type=int, default=0)
    ap.add_argument("--bloom", action="store_true")
    ap.add_argument("--fxaa", action="store_true")
    ap.add_argument("--shadows", action="store_true")
    ap.add_argument("--shadow-map-size", type=int, default=None,
                    help="shadow map resolution (default: RendererConfig's 1024)")
    ap.add_argument("--bump", action="store_true", help="procedural normal mapping")
    ap.add_argument("--orbit", action="store_true", help="camera flythrough")
    ap.add_argument("--fused", action="store_true", help="fused tiled-deferred kernel")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    ap.add_argument("--light-dir", default=None,
                    help="directional light as 'x,y,z' (default: reference)")
    ap.add_argument("--materials", default="reference", choices=["reference", "varied"],
                    help="per-mesh material set (reference red or varied)")
    ap.add_argument("--sun", type=float, default=1.0,
                    help="directional light intensity multiplier")
    ap.add_argument("--ambient", type=float, default=None,
                    help="ambient level (default: RendererConfig.ambient)")
    args = ap.parse_args()

    import d3d12_deferred_renderer_tpu_torch as tp
    from d3d12_deferred_renderer_tpu_torch.runtime import App, save_frames_to_dir

    device = "cpu" if args.cpu else None  # None: the CUDA device
    light_kw = {}
    if args.light_dir:
        light_kw["light_direction"] = tuple(float(t) for t in args.light_dir.split(","))
    if args.sun != 1.0:
        light_kw["light_color"] = (args.sun, args.sun, args.sun)
    if args.ambient is not None:
        light_kw["ambient"] = args.ambient
    cfg = tp.RendererConfig(
        width=args.width,
        height=args.height,
        shading=args.shading,
        bloom=args.bloom,
        fxaa=args.fxaa,
        shadows=args.shadows,
        **({"shadow_map_size": args.shadow_map_size} if args.shadow_map_size else {}),
        normal_mapping=args.bump,
        animate_camera=args.orbit,
        fused=args.fused,
        **light_kw,
        # The benchmark scene's densities exceed the reference-parity
        # defaults: size the per-tile caps like tools/demo.py so that
        # nothing overflows (the render_stats check below would say so).
        **(
            {"max_tris_per_tile": 1024,
             "max_lights_per_tile": max(args.lights, 64),
             "max_live_lights_per_tile": max(args.lights, 64)}
            if args.scene == "benchmark" else {}
        ),
    )

    assets = os.path.join(os.path.dirname(__file__), "..", "assets", "models")
    if args.scene == "reference":
        meshes = [tp.load_obj(os.path.join(assets, f"{m}.obj")) for m in ("cube", "pyramid")]
        placement = "reference"
    else:
        meshes = tp.procedural.benchmark_meshes(n=24)
        placement = "grid"

    geo = tp.build_scene_geometry(meshes)
    lights = tp.random_point_lights(args.lights, cfg=cfg, device=device) if args.lights else None
    materials = tp.Materials.varied(geo.num_meshes, device=device) if args.materials == "varied" else None
    state = tp.make_scene(geo, cfg, lights=lights, placement=placement, materials=materials, device=device)

    # No-silent-drop check.
    _, stats = tp.render_stats(state, cfg)
    overflow = int(stats["overflow"])
    if overflow:
        print(f"WARNING: per-tile capacity overflow on {overflow} tiles — "
              "geometry/lights dropped; raise the caps in RendererConfig")

    with App(state, cfg, present_callback=save_frames_to_dir(args.out)) as app:
        stats = app.run(args.frames)
    print(
        f"rendered {stats.frames} frames at {args.width}x{args.height} on "
        f"{state.time.device} -> {args.out} ({stats.fps:.1f} FPS incl. the kernels' first build)"
    )


if __name__ == "__main__":
    main()
