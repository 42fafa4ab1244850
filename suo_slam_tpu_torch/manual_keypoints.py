"""Manual keypoint labeling tool, the port of `manual_keypoints.py`.

Click >= 3 samples of each semantic keypoint on rendered views of an object
mesh; the means and sample covariances are saved to
`kp_info/obj_XXXXXX_kp_info.json`, the file `data.bop.BopDataset` reads.
Host numpy only (`tools/labeling.py`, `eval/render.py`, `eval/raster.py`):
no OpenGL, no OpenCV, nothing on the card.

    python -m suo_slam_tpu_torch.manual_keypoints --dataset ycbv --obj_id 3 [--data_root ...]
    python -m suo_slam_tpu_torch.manual_keypoints --dataset ycbv --viz   # offscreen grid

Keys: 0-9 / n / p select the keypoint, u undoes its last sample, v opens
the inspection pane (covariance ellipses and the view-pose adjustment:
w / a / s / d rotate, i / o zoom, Enter accepts the pose, Esc goes back),
s saves, q quits. The saved view_pose is the one accepted in the
inspection pane; it canonicalizes symmetric objects' ground truth at train
time. The interactive mode opens a Tk window (`eval/window.py`) and exits
non-zero without a display server; `--viz` needs none.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

K_LABEL = np.array([[420.0, 0, 160.0], [0, 420.0, 120.0], [0, 0, 1.0]])


class LabelSession:
    """The interactive labeling state over a `KeypointLabeler`: the panel
    of views and the inspection pane, driven by `click(x, y)` (panel pixels)
    and `key(char)` (Enter "\\r", Esc "\\x1b"). `image()` is what the window
    shows (BGR); `done` turns True at q. The window forwards its events
    here, and the tests drive it directly."""

    def __init__(self, labeler, kp_names, save_path):
        self.lab = labeler
        self.kp_names = list(kp_names)
        self.save_path = save_path
        self.kp_idx = 0
        self.inspection = None  # (img RGB, ok) while the inspection pane is open
        self.done = False

    def image(self) -> np.ndarray:
        from .eval import raster

        if self.inspection is not None:
            return self.inspection[0][..., ::-1].copy()
        panel = self.lab.render_panel()[..., ::-1].copy()  # RGB -> BGR
        name = self.kp_names[self.kp_idx]
        ns = len(self.lab.samples.get(name, []))
        raster.put_text(panel, f"[{self.kp_idx + 1}/{len(self.kp_names)}] {name} "
                        f"({ns} samples; >=3 to save)", (8, 16), (0, 255, 0))
        return panel

    def click(self, x: int, y: int) -> None:
        """A left-button press at panel pixel (x, y): a sample of the
        selected keypoint on the view under it."""
        h, w = self.lab.hw
        n = len(self.lab.view_poses)
        if self.inspection is not None or not (0 <= x < (n // 2) * w and 0 <= y < 2 * h):
            return
        vi = (y // h) * (n // 2) + (x // w)
        name = self.kp_names[self.kp_idx]
        ok = self.lab.add_sample(name, vi, x % w, y % h)
        print(("added" if ok else "MISSED surface:"), name, "view", vi)

    def key(self, k: str) -> None:
        if self.inspection is not None:
            self._inspect_key(k)
        elif k == "q":
            self.done = True
        elif k == "n":
            self.kp_idx = (self.kp_idx + 1) % len(self.kp_names)
        elif k == "p":
            self.kp_idx = (self.kp_idx - 1) % len(self.kp_names)
        elif len(k) == 1 and k in "0123456789" and int(k) < len(self.kp_names):
            self.kp_idx = int(k)
        elif k == "u":
            name = self.kp_names[self.kp_idx]
            if self.lab.samples.get(name):
                self.lab.samples[name].pop()
        elif k == "v":
            print("Inspect: w/a/s/d rotate, i/o zoom, Enter accept pose, Esc back")
            self.inspection = self.lab.render_inspection()
        elif k == "s":
            if not self.lab.kp_stats():
                print("ERROR: no keypoint has 3 samples yet; nothing saved")
                return
            self.lab.save(self.save_path)
            print("Saved", self.save_path)

    def _inspect_key(self, k: str) -> None:
        from .tools.labeling import adjust_view_pose

        if k == "\x1b":  # Esc
            self.inspection = None
        elif k == "\r":  # Enter: accept the adjusted view pose
            if not self.inspection[1]:
                print("ERROR: some sampled keypoints have < 3 samples; add more or undo them.")
                return
            print("Accepted view_pose (saved with 's'):\n", self.lab.view_pose)
            self.inspection = None
        elif len(k) == 1 and k in "wasdio":
            self.lab.view_pose = adjust_view_pose(self.lab.view_pose, k)
            self.inspection = self.lab.render_inspection()


def _viz(args, data_root, mesh_db) -> int:
    """`--viz`: the labeled keypoints of every object over its 8 views, one
    PNG a object in `--out` (default <data_root>/kp_info_viz)."""
    from .data import png
    from .eval import raster
    from .kp import config as kp_config
    from .tools.labeling import KeypointLabeler, load_kp_info

    out_dir = args.out or os.path.join(data_root, "kp_info_viz")
    os.makedirs(out_dir, exist_ok=True)
    kp_config.load_kp_config(args.dataset, args.kp_config_root)  # as the JAX CLI: must exist
    for obj_id in mesh_db.obj_ids:
        path = os.path.join(data_root, "kp_info", f"obj_{obj_id:06d}_kp_info.json")
        if not os.path.exists(path):
            continue
        kps, _ = load_kp_info(path)
        lab = KeypointLabeler(mesh_db.verts_full[obj_id], mesh_db.faces[obj_id], K_LABEL,
                              diameter=float(mesh_db.diameter[obj_id - 1]))
        panel = lab.render_panel()[..., ::-1].copy()  # RGB -> BGR
        h, w = lab.hw
        n = len(lab.view_poses)
        for vi, T in enumerate(lab.view_poses):
            ox = (vi % (n // 2)) * w
            oy = (vi // (n // 2)) * h
            for name, (mean, _) in kps.items():
                p = T[:3, :3] @ mean + T[:3, 3]
                uvw = K_LABEL @ p
                uv = uvw[:2] / uvw[2]
                col = kp_config.kp_color(name).tolist()
                raster.circle(panel, (int(uv[0] + ox), int(uv[1] + oy)), 3, col)
        fn = os.path.join(out_dir, f"obj_{obj_id:06d}.png")
        png.imwrite(fn, panel)
        print("Wrote", fn)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Label object keypoints on rendered views.")
    ap.add_argument("--dataset", default="ycbv", choices=["ycbv", "tless"])
    ap.add_argument("--obj_id", type=int, default=1)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--kp_config_root", default=None)
    ap.add_argument("--viz", action="store_true",
                    help="Offscreen: render labeled keypoints for all objects")
    ap.add_argument("--out", default=None, help="Output dir for --viz images")
    args = ap.parse_args(argv)
    data_root = args.data_root or os.path.join(os.getcwd(), "data/bop_datasets", args.dataset)
    models = "models_bop-compat" if args.dataset == "ycbv" else "models_cad"

    from .data.mesh import load_mesh_db
    from .eval import window

    if not args.viz and not window.display_server():
        print("manual_keypoints: no display server (DISPLAY and WAYLAND_DISPLAY are unset); "
              "the interactive mode needs one (--viz runs offscreen)", file=sys.stderr)
        return 2
    mesh_db = load_mesh_db(os.path.join(data_root, models))
    if args.viz:
        return _viz(args, data_root, mesh_db)

    from .data import png
    from .kp import config as kp_config
    from .tools.labeling import KeypointLabeler

    obj_id = args.obj_id
    labeler = KeypointLabeler(mesh_db.verts_full[obj_id], mesh_db.faces[obj_id], K_LABEL,
                              diameter=float(mesh_db.diameter[obj_id - 1]))
    cfg = kp_config.load_kp_config(args.dataset, args.kp_config_root)
    session = LabelSession(labeler, cfg.kp_names[obj_id - 1],
                           os.path.join(data_root, "kp_info", f"obj_{obj_id:06d}_kp_info.json"))
    try:
        win = window.Window("manual_keypoints")

        def redraw():
            if session.done:
                win.close()
            else:
                win.show(png.encode(session.image()[..., ::-1]))

        win.on_click(lambda x, y: (session.click(x, y), redraw()))
        win.on_key(lambda k: (session.key(k), redraw()))
        redraw()
        win.run()
    except window.WindowError as e:
        print(f"manual_keypoints: the window failed on display {window.display_server()!r}: "
              f"{e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
