"""Offline binned analysis of a results json (counterpart of the repository's
tools/analysis.py):

    python -m buctd_tpu_torch.tools.analysis binned --gt ann.json --dt results.json [--out out/]
    python -m buctd_tpu_torch.tools.analysis rank   --gt ann.json --dt results.json [--top 20]
    python -m buctd_tpu_torch.tools.analysis qualitative --gt ann.json --dt results.json \\
        --images <image dir> --out out/qual [--worst 20]

``binned`` prints the (overlap x number-of-keypoints) AP matrices
(analysis/evaluation.py::coco_evaluation; ``--out`` writes their PDFs, which
needs matplotlib), ``rank`` the worst instances by OKS, ``qualitative`` writes
GT | prediction images for the worst instances of every bin.  ``--sigmas``
takes the dataset whose OKS sigmas score the instances (coco, the default, or
crowdpose).  Host only: no card.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description="BUCTD offline analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("binned", help="occlusion x num-kpt binned AP matrices")
    b.add_argument("--gt", required=True)
    b.add_argument("--dt", required=True)
    b.add_argument("--out", default=None, help="write benchmark_*.pdf plots here")

    r = sub.add_parser("rank", help="per-instance OKS ranking (worst first)")
    r.add_argument("--gt", required=True)
    r.add_argument("--dt", required=True)
    r.add_argument("--top", type=int, default=20)

    q = sub.add_parser("qualitative", help="side-by-side GT/pred dumps per bin")
    q.add_argument("--gt", required=True)
    q.add_argument("--dt", required=True)
    q.add_argument("--images", required=True)
    q.add_argument("--out", required=True)
    q.add_argument("--worst", type=int, default=20)
    for p in (b, r, q):
        p.add_argument("--sigmas", choices=("coco", "crowdpose"), default="coco")

    args = ap.parse_args(argv)
    from ..data.datasets.coco import COCO_OKS_SIGMAS
    from ..data.datasets.crowdpose import CROWDPOSE_OKS_SIGMAS

    sigmas = {"coco": COCO_OKS_SIGMAS, "crowdpose": CROWDPOSE_OKS_SIGMAS}[args.sigmas]
    if args.cmd == "binned":
        from ..analysis import coco_evaluation
        stats = coco_evaluation(args.gt, args.dt, output_dir=args.out, sigmas=sigmas,
                                make_plots=bool(args.out))
        print(json.dumps({k: v.tolist() for k, v in stats.items()}, indent=2))
        return stats
    if args.cmd == "rank":
        from ..analysis import sort_instance_ap
        from ..data.coco_io import COCOIndex
        ranked = sort_instance_ap(COCOIndex(args.gt), args.dt, sigmas)
        for oks, ann_id, _ in ranked[:args.top]:
            print(f"ann {ann_id}: OKS {oks:.3f}")
        return ranked
    from ..analysis.qualitative_evaluation import binwise_coco_evaluation
    binwise_coco_evaluation(args.gt, args.dt, args.images, args.out, sigmas=sigmas,
                            worst_k=args.worst)
    print(f"wrote qualitative dumps to {args.out}")
    return None


if __name__ == "__main__":
    main()
