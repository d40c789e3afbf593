"""``barcoder-tpu mismatch`` — mismatch-efficacy CLI.

Argument-compatible with the reference's ``python mismatch.py``
(mismatch.py:196-250): modes ``mismatches`` (generate single-nt variants
hitting a desired efficacy grid) and ``recalculate`` (recompute y_pred over
an existing TSV with original/variant column aliasing).
"""

from __future__ import annotations

import argparse
import sys

import pandas as pd
from rich.console import Console

from ..model.mismatch import (
    MismatchParams,
    apply_variant,
    calculate_y_pred,
    change_description,
    generate_mismatches,
)

ORIGINAL_ALIASES = {"original", "perfect", "target"}
VARIANT_ALIASES = {"variant", "mismatch", "spacer"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate mismatches for a list of spacers and/or recalculate y_pred."
    )
    p.add_argument("mode", choices=["mismatches", "recalculate"])
    p.add_argument("--spacers_file", help="TSV with a 'target' column (mismatches mode)")
    p.add_argument("--existing_mismatches", help="TSV input (recalculate mode)")
    p.add_argument("--parameters_file", required=True, help="CSV parameters file")
    p.add_argument("--min", type=float, default=0.0)
    p.add_argument("--max", type=float, default=1.0)
    p.add_argument("--step", type=float, default=0.1)
    return p


def run_mismatches(args, params: MismatchParams, out=None) -> None:
    out = out if out is not None else sys.stdout
    data = pd.read_csv(args.spacers_file, sep="\t")
    if "target" not in data.columns:  # reference assumes it (mismatch.py:133)
        # ValueError, not SystemExit: main() catches it into the styled
        # red-message-exit-1 path like every sibling error (a raised
        # SystemExit killed in-process callers, e.g. the GUI dispatch)
        raise ValueError(
            f"mismatches mode needs a 'target' column in {args.spacers_file} "
            f"(found: {', '.join(map(str, data.columns))})"
        )
    out.write("\t".join(["original", "variant", "change_description", "y_pred"]) + "\n")
    for _, row in data.iterrows():
        spacer_original = row["target"]
        spacer = spacer_original.upper()
        for variant, score in generate_mismatches(spacer, args.min, args.max, args.step, params):
            out.write(
                "\t".join(
                    [
                        spacer_original,
                        apply_variant(spacer_original, variant),
                        change_description(spacer_original, variant),
                        f"{score:.4f}",
                    ]
                )
                + "\n"
            )


def run_recalculate(args, params: MismatchParams, out=None) -> int:
    out = out if out is not None else sys.stdout
    console = Console(file=sys.stderr)
    data = pd.read_csv(args.existing_mismatches, sep="\t")
    original_col = ORIGINAL_ALIASES.intersection(data.columns)
    variant_col = VARIANT_ALIASES.intersection(data.columns)
    if not (len(original_col) == 1 and len(variant_col) == 1):
        console.log(
            "[bold red]Input data file must have one of[/bold red] 'original', "
            "'target', or 'perfect' [bold red]columns and one of[/bold red] "
            "'variant', 'spacer', or 'mismatch' columns."
        )
        return 1
    original_col = original_col.pop()
    variant_col = variant_col.pop()

    new_col = "y_pred_new" if "y_pred" in data.columns else "y_pred"

    def calc(row):
        o = row[original_col]
        v = row[variant_col]
        y = calculate_y_pred(
            o.upper() if isinstance(o, str) else o,
            v.upper() if isinstance(v, str) else v,
            params,
        )
        return None if y is None else f"{y:.4f}"

    data[new_col] = data.apply(calc, axis=1)

    # reference: float columns holding only integral values → Int64
    for col in data.columns:
        if data[col].dtype == "float64":
            nonnull = data[col].dropna()
            if len(nonnull) and (nonnull == nonnull.astype(int)).all():
                data[col] = data[col].astype("Int64")

    out.write(data.to_csv(sep="\t", index=False, na_rep="None"))
    out.write("\n")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    console = Console(file=sys.stderr)
    console.log("[bold red]Initializing mismatch calculator[/bold red]")
    if args.mode == "mismatches" and args.spacers_file is None:
        console.log("[bold red]--spacers_file is required for mismatches mode[/bold red]")
        return 2
    if args.mode == "recalculate" and args.existing_mismatches is None:
        console.log("[bold red]--existing_mismatches is required for recalculate mode[/bold red]")
        return 2
    # top-level user-input error contract (targets.py:703-712 equivalent):
    # friendly red message + exit 1, no raw traceback
    try:
        params = MismatchParams.from_csv(args.parameters_file)
        if args.mode == "mismatches":
            run_mismatches(args, params)
            return 0
        return run_recalculate(args, params)
    except FileNotFoundError as e:
        console.log(f"[bold red]File not found[/bold red]: {e.filename or e}")
        return 1
    except (ValueError, KeyError, OSError) as e:
        # malformed/empty inputs (pandas ParserError/EmptyDataError are
        # ValueError subclasses), bad columns, unreadable files — the
        # reference wraps its read_csv in `except Exception → exit 1`
        # (mismatch.py:123-126,140-144); raw tracebacks break the contract
        console.log(f"[bold red]Could not process input[/bold red]: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
