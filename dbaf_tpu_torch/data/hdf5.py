"""HDF5 cache of preprocessed frames (port of ``dbaf_tpu/data/hdf5.py``).

The reference's dataset/{tumvi,euroc,kitti360}_to_hdf5.py: undistorted and
resized frames, one pickled ``(t, image, intrinsics)`` tuple per key, so
repeated runs skip the OpenCV work (``--enable_h5``, demo_vio_tumvi.py:68-74).
The format is the JAX package's: a cache either package writes reads in the
other.  Needs h5py, imported when a function runs.

    python -m dbaf_tpu_torch.data.hdf5 --dataset tumvi --datadir ... \\
        --calib calib/tumvi.txt --out frames.h5 [--stride 4]
"""

from __future__ import annotations

import pickle
from typing import Iterable, Iterator, Tuple

import numpy as np


def convert_stream(stream: Iterable, out_path: str):
    """Write a (t, image, intrinsics) stream into an HDF5 cache."""
    import h5py

    with h5py.File(out_path, "w") as f:
        for k, item in enumerate(stream):
            f.create_dataset("%08d" % k, data=np.void(pickle.dumps(item)))


def h5_stream(path: str) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """The cached items in key order (pickle: read only trusted files)."""
    import h5py

    with h5py.File(path, "r") as f:
        for key in sorted(f.keys()):
            yield pickle.loads(np.asarray(f[key]).tobytes())


def main(argv=None):
    """The converter's command line (the dataset/*_to_hdf5.py scripts)."""
    import argparse

    from . import streams

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["tumvi", "kitti360", "generic"], default="generic")
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--imagestamp", default=None,
                    help="timestamp<->filename map (KITTI-360 layout: "
                         "whitespace-delimited, kitti360_to_hdf5.py:35-36)")
    args = ap.parse_args(argv)

    if args.dataset == "tumvi":
        stream = streams.tumvi_stream(args.datadir, args.calib, args.stride)
    elif args.dataset == "kitti360":
        stream = streams.kitti360_stream(args.datadir, args.calib, args.stride,
                                         stamp_path=args.imagestamp)
    else:
        stream = streams.image_stream(args.datadir, args.calib, args.stride)
    convert_stream(stream, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
