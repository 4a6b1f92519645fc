"""comm_report: print (or regenerate) the port's golden comm-contract
tables (counterpart of tools/comm_report.py).

Reads the manifests in megatron_tpu_torch/analysis/golden/ and prints
each configuration's comm.* calls per step by collective, with the wire
bytes where the byte model prices them (analysis/contracts.py).

    python -m megatron_tpu_torch.tools.comm_report                # table
    python -m megatron_tpu_torch.tools.comm_report --config train_pp2
    python -m megatron_tpu_torch.tools.comm_report --diff \\
        decode_tp2_dense decode_tp2_int8     # per-collective deltas and
                                             # the wire-byte ratio
    python -m megatron_tpu_torch.tools.comm_report --check   # re-measure
    python -m megatron_tpu_torch.tools.comm_report --regen [name ...]

--check re-measures every manifest (one two-rank gloo launch on the CPU,
~15 s) and diffs it against golden, then verifies the compression gates
(contracts.COMPRESSION_GATES: the int8 decode tick must stay >= 3x below
the dense one in wire bytes). Printing and --diff import no torch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "analysis" / "golden"


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _collectives(manifest: dict) -> dict:
    return manifest.get("comm", {}).get("collectives", {})


def _print_manifest(name: str, manifest: dict) -> None:
    geo = manifest.get("geometry", {})
    print(f"\n== {name} (torch "
          f"{manifest.get('toolchain', {}).get('torch', '?')}, "
          f"{manifest.get('world', '?')} ranks, per "
          f"{manifest.get('marker', '?')}; "
          + " ".join(f"{k}={v}" for k, v in sorted(geo.items())) + ") ==")
    colls = _collectives(manifest)
    if not colls:
        print("  comm.* calls: none")
    for op, v in colls.items():
        print(f"  {op:<22} count={v['count']:>4}")
    wire = manifest.get("comm", {}).get("total_wire_bytes")
    if wire is not None:
        print(f"  {'TOTAL wire':<22} {_fmt_bytes(wire)}")


def _load(name: str) -> dict:
    """A manifest by config name (golden dir) or explicit JSON path."""
    path = Path(name)
    if not path.exists():
        path = GOLDEN_DIR / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no manifest for {name!r} (looked at {path})")
    return json.loads(path.read_text())


def _diff_manifests(name_a: str, name_b: str) -> int:
    """Per-collective count deltas A -> B and the total wire-byte ratio
    (the dense-vs-compressed reduction)."""
    a, b = _load(name_a), _load(name_b)
    ca, cb = _collectives(a), _collectives(b)
    keys = sorted(set(ca) | set(cb))
    w = max([len(k) for k in keys] + [16])
    print(f"{'collective':<{w}}  {'count':>11}")
    print(f"{'':<{w}}  {name_a[:11]:>5}>{name_b[:11]:<5}")
    for k in keys:
        na = ca.get(k, {}).get("count", 0)
        nb = cb.get(k, {}).get("count", 0)
        print(f"{k:<{w}}  {na:>5}>{nb:<5}")
    ta = a.get("comm", {}).get("total_wire_bytes", 0)
    tb = b.get("comm", {}).get("total_wire_bytes", 0)
    print(f"{'TOTAL wire':<{w}}  {_fmt_bytes(ta):>10}>{_fmt_bytes(tb):<10}")
    if tb > 0:
        print(f"wire-byte ratio {name_a} / {name_b}: {ta / tb:.2f}x")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append", default=None,
                    help="limit to these config names (repeatable)")
    ap.add_argument("--check", action="store_true",
                    help="re-measure each manifest and diff against golden "
                         "(+ verify the compression gates)")
    ap.add_argument("--regen", nargs="*", metavar="NAME", default=None,
                    help="re-measure and REWRITE golden manifests (all "
                         "when no names given)")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="per-collective count deltas between two "
                         "manifests (config names or JSON paths)")
    args = ap.parse_args(argv)

    exclusive = [n for n, v in (("--check", args.check),
                                ("--regen", args.regen is not None),
                                ("--diff", args.diff is not None)) if v]
    if len(exclusive) > 1:
        ap.error(" and ".join(exclusive) + " are mutually exclusive")
    if args.diff is not None:
        return _diff_manifests(*args.diff)
    if args.regen is not None or args.check:
        from megatron_tpu_torch.analysis import contracts

        names = args.regen or args.config or sorted(contracts.CONFIGS)
        if args.regen is not None:
            for path in contracts.write_manifests(names):
                print(f"wrote {path}")
            return 0
        fresh = contracts.build_manifests(names)
        problems = []
        for name in names:
            problems += contracts.check_contract(name, fresh[name])
        gated = {n for pair in contracts.COMPRESSION_GATES
                 for n in pair[:2]}
        if gated & set(names):
            problems += contracts.check_compression_gates(fresh)
        for p in problems:
            print(p)
        print("comm contracts:", "OK" if not problems else
              f"{len(problems)} mismatch(es)")
        return 1 if problems else 0

    names = args.config or sorted(p.stem for p in GOLDEN_DIR.glob("*.json"))
    if not names:
        print(f"no golden manifests in {GOLDEN_DIR} — generate with "
              "--regen", file=sys.stderr)
        return 1
    for name in names:
        path = GOLDEN_DIR / f"{name}.json"
        if not path.exists():
            print(f"{name}: no golden manifest at {path}", file=sys.stderr)
            return 1
        _print_manifest(name, json.loads(path.read_text()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
