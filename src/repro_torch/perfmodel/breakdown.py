"""Per-op breakdown of a cell's per-device bytes and collective bytes.

The hillclimbing profiler: attribute a counted step's bytes to aten ops and
its collective traffic to collective kinds, so that the dominant-term
hypotheses rest on the program that actually runs.  The reference's
``perfmodel/breakdown.py`` walks compiled HLO by computation; here the
counts come from the same pass as :mod:`.opcount`, so the breakdown is by op
name.  ``python -m repro_torch.perfmodel.breakdown <arch> <shape>`` counts
a cell on the 256-card mesh (as the dry-run does) and prints the top
contributors.
"""

from __future__ import annotations

from .opcount import OpReport

__all__ = ["breakdown", "main"]


def breakdown(report: OpReport) -> tuple[dict, dict]:
    """(bytes by aten op, collective bytes by collective kind)."""
    return dict(report.bytes_by_op), dict(report.collective_by_op)


def main(argv: list[str] | None = None) -> None:
    import argparse

    from ..configs import SHAPES, apply_variants, get_config
    from ..distributed import axis_rules
    from ..launch.mesh import make_production_mesh, release_process_group
    from ..launch.specs import count_cell, make_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape", choices=list(SHAPES))
    ap.add_argument("--variants", default="")
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.variants:
        cfg = apply_variants(cfg, args.variants.split(","))
    try:
        mesh = make_production_mesh()
        with axis_rules(mesh):
            rep = count_cell(make_cell(cfg, SHAPES[args.shape]), mesh)
    finally:
        release_process_group()
    by_op, coll = breakdown(rep)
    print(f"== bytes by op (top {args.top}) ==")
    for op, b in sorted(by_op.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {b:12.3e}  {op}")
    print("== collective bytes by op ==")
    for k, b in sorted(coll.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {b:12.3e}  {k}")


if __name__ == "__main__":
    main()
