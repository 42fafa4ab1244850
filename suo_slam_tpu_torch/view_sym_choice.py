"""Symmetry-choice inspector, the port of `view_sym_choice.py`.

For one scene / view / object, renders the object shaded under every
candidate symmetry composition T_OtoC @ T_sym over the camera image and
marks the one `BopDataset.pick_symmetry_transform` selects (green border)
against the rest (red). Writes a grid PNG; `--show` also opens a Tk window
(`eval/window.py`; it exits non-zero without a display server). Host numpy
only: nothing runs on the card.

    python -m suo_slam_tpu_torch.view_sym_choice --dataset ycbv --obj_id 3 [--data_root ...]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Show the symmetry candidates of one object.")
    ap.add_argument("--dataset", default="ycbv", choices=["ycbv", "tless"])
    ap.add_argument("--split", default="test")
    ap.add_argument("--scene_id", type=int, default=0)
    ap.add_argument("--view_id", type=int, default=0)
    ap.add_argument("--obj_id", type=int, default=1)
    ap.add_argument("--data_root", default=None)
    ap.add_argument("--kp_config_root", default=None)
    ap.add_argument("--max_syms", type=int, default=16,
                    help="Cap the number of rendered candidates")
    ap.add_argument("--out", default="sym_choice.png")
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)
    data_root = args.data_root or os.path.join(os.getcwd(), "data/bop_datasets", args.dataset)

    from .data import png
    from .data.bop import BopDataset
    from .data.mesh import load_mesh_db
    from .eval import raster, window
    from .eval.render import render_shaded

    if args.show and not window.display_server():
        print("view_sym_choice --show: no display server (DISPLAY and WAYLAND_DISPLAY are "
              "unset)", file=sys.stderr)
        return 2
    ds = BopDataset(data_root, args.split, bop_dset=args.dataset,
                    kp_config_root=args.kp_config_root, seed=0)
    db = load_mesh_db(ds.models_dir)
    K = ds.data[args.scene_id][args.view_id].K
    T_gt = ds.get_obj_pose(args.scene_id, args.view_id, args.obj_id)
    T_best, i_best = ds.pick_symmetry_transform(args.obj_id - 1, T_gt)
    syms = ds.symmetries[args.obj_id - 1]
    img = ds.read_img(args.scene_id, args.view_id)
    hw = img.shape[:2]

    step = max(1, len(syms) // args.max_syms)
    idxs = list(range(0, len(syms), step))
    if i_best not in idxs:
        idxs.append(i_best)
    tiles = []
    T4 = np.eye(4)
    T4[:3, :] = T_gt[:3, :]
    for i in sorted(idxs):
        rgb, d = render_shaded(db.verts_full[args.obj_id], db.faces[args.obj_id], K,
                               T4 @ syms[i], hw, color=(80, 220, 220))
        mask = d > 0
        tile = img.copy()
        # the shaded candidate blended over the camera image (float64,
        # truncated on assignment into uint8)
        tile[mask] = (0.4 * tile[mask] + 0.6 * rgb[mask][..., ::-1]).clip(0, 255)
        color = (0, 255, 0) if i == i_best else (0, 0, 255)
        raster.rectangle(tile, (1, 1), (hw[1] - 2, hw[0] - 2), color, 3)
        raster.put_text(tile, f"sym {i}", (8, 20), color, "plain_1.2_t2")
        tiles.append(tile)
    cols = int(np.ceil(np.sqrt(len(tiles))))
    rows = int(np.ceil(len(tiles) / cols))
    grid = np.zeros((rows * hw[0], cols * hw[1], 3), np.uint8)
    for k, t in enumerate(tiles):
        r, c = divmod(k, cols)
        grid[r * hw[0]: (r + 1) * hw[0], c * hw[1]: (c + 1) * hw[1]] = t
    png.imwrite(args.out, grid)
    print(f"Best symmetry index: {i_best}/{len(syms)}; wrote {args.out}")
    if args.show:  # until a key is pressed
        try:
            win = window.Window("sym_choice")
            win.on_key(lambda k: win.close())
            win.show(png.encode(grid[..., ::-1]))
            win.run()
        except window.WindowError as e:
            print(f"view_sym_choice --show: the window failed on display "
                  f"{window.display_server()!r}: {e}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
