"""COLMAP SfM front end — required preprocessing for DTU / custom data.

A copy of the JAX package's `apps/convert.py` (it imports no JAX); it
mirrors `convert.py:31-122`: feature extraction -> exhaustive matching ->
mapper -> image_undistorter -> sparse/0 layout -> optional x2/4/8 resizes.
Requires the `colmap` (and optionally ImageMagick `magick`/`convert`)
binaries on PATH."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser


def run(cmd: str) -> None:
    code = os.system(cmd)
    if code != 0:
        print(f"command failed with {code}: {cmd}")
        sys.exit(code)


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="")
    args = parser.parse_args(argv)

    colmap_command = (
        f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    )
    magick_command = (
        f'"{args.magick_executable}"' if args.magick_executable else "magick"
    )
    use_gpu = 1 if not args.no_gpu else 0

    if not args.skip_matching:
        os.makedirs(args.source_path + "/distorted/sparse", exist_ok=True)
        run(
            f"{colmap_command} feature_extractor "
            f"--database_path {args.source_path}/distorted/database.db "
            f"--image_path {args.source_path}/input "
            f"--ImageReader.single_camera 1 "
            f"--ImageReader.camera_model {args.camera} "
            f"--SiftExtraction.use_gpu {use_gpu}"
        )
        run(
            f"{colmap_command} exhaustive_matcher "
            f"--database_path {args.source_path}/distorted/database.db "
            f"--SiftMatching.use_gpu {use_gpu}"
        )
        run(
            f"{colmap_command} mapper "
            f"--database_path {args.source_path}/distorted/database.db "
            f"--image_path {args.source_path}/input "
            f"--output_path {args.source_path}/distorted/sparse "
            f"--Mapper.ba_global_function_tolerance=0.000001"
        )

    run(
        f"{colmap_command} image_undistorter "
        f"--image_path {args.source_path}/input "
        f"--input_path {args.source_path}/distorted/sparse/0 "
        f"--output_path {args.source_path} --output_type COLMAP"
    )

    sparse_dir = os.path.join(args.source_path, "sparse")
    os.makedirs(os.path.join(sparse_dir, "0"), exist_ok=True)
    for file in os.listdir(sparse_dir):
        if file == "0":
            continue
        shutil.move(
            os.path.join(sparse_dir, file), os.path.join(sparse_dir, "0", file)
        )

    if args.resize:
        print("Copying and resizing...")
        for factor, pct in ((2, "50%"), (4, "25%"), (8, "12.5%")):
            dst = os.path.join(args.source_path, f"images_{factor}")
            os.makedirs(dst, exist_ok=True)
            for file in os.listdir(os.path.join(args.source_path, "images")):
                src = os.path.join(args.source_path, "images", file)
                dest = os.path.join(dst, file)
                shutil.copy2(src, dest)
                run(f"{magick_command} mogrify -resize {pct} {dest}")

    print("Done.")


if __name__ == "__main__":
    main()
