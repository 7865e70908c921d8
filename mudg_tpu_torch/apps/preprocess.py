"""Waymo tfrecord -> processed scene directories (CLI).

Port of `mudg_tpu/apps/preprocess.py` (reference `data_process/
preprocess.py:536-585`): every sequence of a list (or every *.tfrecord
under --root) goes through `data/waymo_etl.process_sequence`, which writes
images/, lidars/ and scenario.pt under --out_root/<scene_id>/; the ray and
pose math runs on --device (default cuda). With -j above 1 the sequences go
to a pool of spawned worker processes, each with its own CUDA context (the
parent touches no device before the pool starts).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent import futures


def file_to_scene_id(path: str) -> str:
    """segment-XXXX_with_camera_labels.tfrecord -> the scene id
    (tools/waymo_dataset.py:171-177)."""
    name = os.path.basename(path)
    return name[:-len(".tfrecord")] if name.endswith(".tfrecord") else name


def list_sequences(root: str, seq_list: str | None) -> list[str]:
    if seq_list:
        with open(seq_list) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        out = []
        for n in names:
            p = n if os.path.isabs(n) else os.path.join(root, n)
            if not p.endswith(".tfrecord"):
                p += ".tfrecord"
            out.append(p)
        return out
    return sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(".tfrecord"))


def process_one(seq_path: str, out_root: str, no_images: bool, no_lidar: bool,
                device: str = "cuda") -> str:
    from ..data.waymo_etl import process_sequence

    scene_id = file_to_scene_id(seq_path)
    process_sequence(seq_path, os.path.join(out_root, scene_id), save_images=not no_images,
                     save_lidar=not no_lidar, device=device)
    return scene_id


def main(argv=None):
    ap = argparse.ArgumentParser("mudg preprocess", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="directory of raw .tfrecord sequences")
    ap.add_argument("--out_root", required=True, help="output root; one sub-dir per scene")
    ap.add_argument("--seq_list", default=None,
                    help="optional text file of sequence names to process")
    ap.add_argument("-j", type=int, default=4, help="max worker processes")
    ap.add_argument("--no_images", action="store_true")
    ap.add_argument("--no_lidar", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    seqs = list_sequences(args.root, args.seq_list)
    if not seqs:
        raise SystemExit(f"no .tfrecord sequences under {args.root}")
    os.makedirs(args.out_root, exist_ok=True)

    workers = max(1, min(args.j, len(seqs)))
    job = (args.out_root, args.no_images, args.no_lidar, args.device)
    if workers == 1:
        for s in seqs:
            print(f"=> {process_one(s, *job)}")
    else:
        # spawned, not forked: a forked child cannot use a CUDA context
        ctx = multiprocessing.get_context("spawn")
        with futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            futs = {ex.submit(process_one, s, *job): s for s in seqs}
            for fut in futures.as_completed(futs):
                print(f"=> {fut.result()}")
    print(f"done: {len(seqs)} sequence(s) -> {args.out_root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
