"""The command line: the ``spades.py`` surface of the port.

PyTorch counterpart of the JAX package's ``cli.py`` (the
reference's top-level orchestration, assembler/spades.py:593 main, options
at spades_pipeline/options_parser.py, checkpointing semantics of
--continue/--restart-from/--stop-after at spades.py:179-418): parse
libraries, pick the K ladder, run the stage pipeline
(pipeline/spades_stages.py) under the checkpointing StageManager, writing
the reference's output layout (contigs.fasta, scaffolds.fasta,
before_rr.fasta, assembly_graph_with_scaffolds.gfa, assembly_graph.fastg,
spades.log, params.json, saves/).

The run is on a CUDA card unless ``--device cpu`` is given; without a card
and without that flag it exits 1 before it reads anything. Long reads
(``--pacbio``, ``--nanopore``, ``--sanger``) add the two hybrid stages
after gap closing and guide repeat resolution; ``--bio`` and ``--corona``
with ``--custom-hmms`` add domain extraction before the second phase and
the domain graph (``gene_clusters.fasta``, ``bgc_statistics.txt``,
``domain_graph.dot``) at the end; ``--series-analysis`` profiles the
graph's edges against a multi-sample k-mer table before repeat
resolution. ``--careful`` adds mismatch correction after gap closing;
``--assembly-graph`` loads a GFA graph in place of the K ladder. The
modes run as in the JAX package: ``--meta`` with its second phase and
second repeat resolution, ``--plasmid``, ``--metaplasmid`` and
``--metaviral`` with chromosome removal and the circular (and linear)
candidates, ``--rna`` with its strand split (``--ss``), ``--rnaviral``,
``--corona`` without HMMs (as rnaviral), ``--moleculo`` and ``--sc``.

Paired libraries (``-1/-2``, ``--12``, ``--mp-1/--mp-2``) add gap
closing and paired repeat resolution (exSPAnder path extension, loop
traversal, scaffolding, gap polishing) after the K ladder, and the run
writes ``contigs.paths``, ``scaffolds.paths``, ``final.lib_data``,
``scaffold_graph.scg`` and ``scaffold_graph.dot`` besides the files
above; the GFA then carries the scaffolds as P-lines.

Usage:
    python -m spades_for_blackbird_tpu_torch -1 reads_1.fq.gz \\
        -2 reads_2.fq.gz -o out                    # on the card
    python -m spades_for_blackbird_tpu_torch -1 reads_1.fq.gz \\
        -2 reads_2.fq.gz -o out --device cpu       # on the CPU
    python -m spades_for_blackbird_tpu_torch -s reads.fq.gz -o out \\
        --only-assembler
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .io import fastq
from .pipeline import assemble, spades_stages
from .pipeline.config import config_for_mode
from .pipeline.stages import PipelineContext, StageManager
from .utils import logger as logmod
from .utils import membudget, timetrace
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spades_for_blackbird_tpu_torch",
        description="genome assembler on an NVIDIA GPU, in PyTorch and CUDA "
                    "(SPAdes-compatible surface)")
    p.add_argument("-1", dest="pe1", action="append", default=[],
                   help="file with forward paired-end reads")
    p.add_argument("-2", dest="pe2", action="append", default=[],
                   help="file with reverse paired-end reads")
    p.add_argument("-s", dest="single", action="append", default=[],
                   help="file with unpaired reads")
    p.add_argument("--12", dest="interlaced", action="append", default=[],
                   help="file with interlaced paired-end reads")
    p.add_argument("--pe-orientation", dest="pe_orientation",
                   choices=["fr", "rf", "ff"], default="fr",
                   help="paired-end library orientation "
                        "(--pe#-fr/rf/ff in the reference)")
    p.add_argument("--mp-orientation", dest="mp_orientation",
                   choices=["rf", "fr", "ff"], default="rf",
                   help="mate-pair library orientation "
                        "(--mp#-rf/fr/ff in the reference)")
    p.add_argument("--mp-1", dest="mp1", action="append", default=[],
                   help="file with forward mate-pair (RF) reads")
    p.add_argument("--mp-2", dest="mp2", action="append", default=[],
                   help="file with reverse mate-pair (RF) reads")
    p.add_argument("--pacbio", action="append", default=[],
                   help="file with PacBio reads (hybrid assembly)")
    p.add_argument("--nanopore", action="append", default=[],
                   help="file with Nanopore reads (hybrid assembly)")
    p.add_argument("--sanger", action="append", default=[],
                   help="file with Sanger reads (hybrid assembly)")
    p.add_argument("--assembly-graph", default=None, metavar="GFA",
                   help="start from an existing assembly graph instead of "
                        "construction (the blackbird-fork LoadGraph path)")
    p.add_argument("-o", dest="output_dir", required=True,
                   help="output directory")
    p.add_argument("-k", dest="k_list", default=None,
                   help="comma-separated odd k values (default: auto)")
    p.add_argument("--only-assembler", action="store_true",
                   help="skip read error correction")
    p.add_argument("--only-error-correction", action="store_true",
                   help="run read error correction only")
    p.add_argument("--careful", action="store_true",
                   help="run the mismatch-correction polishing stage")
    p.add_argument("--meta", action="store_true",
                   help="metagenomic mode (metaSPAdes equivalent)")
    p.add_argument("--plasmid", action="store_true",
                   help="plasmid mode (plasmidSPAdes equivalent)")
    p.add_argument("--metaplasmid", action="store_true",
                   help="metaplasmid/metaviral mode")
    p.add_argument("--rna", action="store_true",
                   help="RNA-seq mode (rnaSPAdes equivalent)")
    p.add_argument("--rnaviral", action="store_true",
                   help="viral RNA mode (rnaviralSPAdes equivalent)")
    p.add_argument("--corona", action="store_true",
                   help="coronaSPAdes mode (rnaviral pipeline + HMM "
                        "domain graph; pass the HMM set via "
                        "--custom-hmms)")
    p.add_argument("--metaviral", action="store_true",
                   help="metaviral mode (circular + linear viral "
                        "candidates from a metagenome)")
    p.add_argument("--moleculo", "--truseq", dest="moleculo",
                   action="store_true",
                   help="truSPAdes barcode-assembly mode "
                        "(moleculo_mode.info)")
    p.add_argument("--large-genome", dest="large_genome",
                   action="store_true",
                   help="large-genome mode; accepted for the reference's "
                        "command line: its overlay names the 2015 "
                        "scaffolding mode, which neither this package nor "
                        "the JAX package reads yet, so it changes nothing")
    p.add_argument("--iontorrent", action="store_true",
                   help="IonTorrent data: homopolymer-space error "
                        "correction (ionhammer)")
    p.add_argument("--sc", action="store_true",
                   help="single-cell (MDA) mode")
    p.add_argument("--series-analysis", dest="series_analysis",
                   default=None, metavar="YAML",
                   help="mts time-series binning hook: profile graph "
                        "edges against a multi-sample k-mer table")
    p.add_argument("--bio", action="store_true",
                   help="biosyntheticSPAdes mode (BGC assembly; needs "
                        "--custom-hmms)")
    p.add_argument("--custom-hmms", dest="custom_hmms", default=None,
                   metavar="PATH",
                   help=".hmm file or directory of domain models for "
                        "--bio mode")
    p.add_argument("--ss", choices=["rf", "fr"], default=None,
                   help="strand-specific RNA library orientation "
                        "(enables the SSEdgeSplit stage in --rna mode)")
    p.add_argument("--test", action="store_true",
                   help="run on the reference's toy dataset "
                        "(ecoli_1K_1.fq.gz and ecoli_1K_2.fq.gz in the "
                        "directory $SFB_TEST_DATASET)")
    p.add_argument("--min-contig-length", type=int, default=None)
    p.add_argument("--cov-cutoff", default="off", metavar="N|auto|off",
                   help="drop (k+1)-mers with count below N before "
                        "construction ('auto' uses the coverage model)")
    p.add_argument("--continue", dest="continue_run", action="store_true",
                   help="resume from the last completed stage")
    p.add_argument("--restart-from", default=None, metavar="STAGE",
                   help="restart from a stage (e.g. k33, repeat_resolution)")
    p.add_argument("--stop-after", default=None, metavar="STAGE",
                   help="stop after the given stage")
    p.add_argument("--checkpoints", choices=["none", "last", "all"],
                   default="last", help="per-stage saves policy")
    p.add_argument("--trace-time", action="store_true",
                   help="emit Chrome-trace JSON of stage/phase timings")
    p.add_argument("--threads", "-t", type=int, default=None,
                   help="accepted for CLI compatibility (device-parallel)")
    p.add_argument("--device", default=None, metavar="DEVICE",
                   help="where the assembly runs: a CUDA card by default "
                        "(cuda, cuda:1, ...); 'cpu' is the only way onto "
                        "the CPU")
    p.add_argument("--memory", "-m", type=int, default=None,
                   help="host memory budget in GB (spades.py:239 -m): a "
                        "stage whose peak RSS exceeds it logs a warning")
    p.add_argument("--log-properties", default=None, metavar="FILE",
                   help="per-component log levels (log.properties format; "
                        "SPADES_TPU_LOG env overlays)")
    return p


def _error(msg: str, code: int = 2) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.test:
        dataset = os.environ.get("SFB_TEST_DATASET", "")
        args.pe1 = [os.path.join(dataset, "ecoli_1K_1.fq.gz")]
        args.pe2 = [os.path.join(dataset, "ecoli_1K_2.fq.gz")]

    if len(args.pe1) != len(args.pe2):
        return _error("-1/-2 file counts differ")
    if len(args.mp1) != len(args.mp2):
        return _error("--mp-1/--mp-2 file counts differ")
    if not (args.pe1 or args.single or args.interlaced or args.mp1):
        return _error("no input reads (use -1/-2, -s, --12 or --test)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:  # no card, and the CPU was not asked for
        return _error(str(e), code=1)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "spades.log"), "a") as log_f:
        def file_writer(line):
            log_f.write(line + "\n")
            log_f.flush()

        # leveled per-component logging (utils/logger/logger.hpp:161 +
        # log.properties): console + spades.log writers for this run
        # only; the logger's earlier configuration comes back with the
        # end of the block, before the file closes
        with logmod.configured(properties_path=args.log_properties,
                               writers=[print, file_writer]):
            if args.memory is not None:
                membudget.set_budget_gb(args.memory)
            try:
                return _run(args, device)
            finally:
                timetrace.disable()
                if args.memory is not None:
                    membudget.set_budget_gb(None)


def _run(args, device) -> int:
    """``main`` after the log is open: 0, or 2 for a request it refuses."""
    log = logmod.get_logger("pipeline").info

    missing = [p for p in (args.pe1 + args.pe2 + args.mp1 + args.mp2 +
                           args.single +
                           args.interlaced + args.pacbio + args.nanopore +
                           args.sanger +
                           ([args.assembly_graph] if args.assembly_graph
                            else []))
               if not os.path.exists(p)]
    if missing:
        return _error(f"input file(s) not found: {missing}")

    first_file = (args.pe1 or args.single or args.interlaced
                  or args.mp1)[0]
    read_length = fastq.peek_read_length(first_file)
    if read_length == 0:
        return _error(f"no reads found in {first_file}")

    if args.k_list:
        try:
            ks = [int(x) for x in args.k_list.split(",")]
        except ValueError:
            return _error(f"bad -k value {args.k_list!r} "
                          f"(expected comma-separated integers)")
        bad = [k for k in ks if k % 2 == 0 or k < 11 or k >= read_length]
        if bad:
            return _error(f"k values must be odd, >= 11 and < read length "
                          f"({read_length}); got {bad}")
    else:
        ks = [k for k in assemble.default_k_ladder(read_length)
              if k < read_length]
    log(f"K values: {ks}")

    mode_flags = [m for m in ("meta", "plasmid", "metaplasmid",
                              "metaviral", "rna", "rnaviral", "corona",
                              "sc", "bio", "moleculo", "large_genome")
                  if getattr(args, m)]
    if len(mode_flags) > 1:
        return _error(f"conflicting mode flags: {mode_flags}")
    mode = mode_flags[0] if mode_flags else "isolate"
    if mode == "bio" and not args.custom_hmms:
        return _error("--bio requires --custom-hmms <file-or-dir of .hmm "
                      "models>")
    if mode == "corona" and not args.custom_hmms:
        # the reference bundles coronaspades_hmms (options_parser.py:937);
        # the set ships out-of-tree here, so the domain stages are
        # skipped unless a set is supplied
        log("warning: --corona without --custom-hmms: HMM domain-graph "
            "postprocessing skipped (supply the coronavirus HMM set "
            "via --custom-hmms)")
    if args.custom_hmms and not os.path.exists(args.custom_hmms):
        return _error(f"--custom-hmms path not found: {args.custom_hmms}")
    cfg = config_for_mode(mode, careful=args.careful)
    if cfg.ks is not None and not args.k_list:
        ks = [k for k in cfg.ks if k < read_length]
        log(f"mode {mode}: K values {ks}")
    log(f"mode: {mode}; device: {device}")

    stages = spades_stages.build_stage_list(args, ks, log, cfg, device)
    if args.only_error_correction:
        stages = [s for s in stages
                  if s.name in ("read_conversion", "error_correction")]
    mgr = StageManager(stages=stages, output_dir=args.output_dir,
                       checkpoints=args.checkpoints, log=log, device=device)
    how = dict(continue_run=args.continue_run,
               restart_from=args.restart_from, stop_after=args.stop_after)
    # refuse a bad restart or stop stage before any work
    try:
        mgr.planned(**how)
    except ValueError as e:
        return _error(str(e))

    if args.trace_time:
        timetrace.enable()
    mgr.run(PipelineContext(), **how)

    with open(os.path.join(args.output_dir, "params.json"), "w") as f:
        json.dump({"ks": ks, "read_length": read_length,
                   "stages": [s.name for s in stages]}, f)
    if args.trace_time:
        trace_path = os.path.join(args.output_dir, "spades_time_trace.json")
        timetrace.dump(trace_path)
        log(f"wrote {trace_path}")
    log("done")
    return 0


def _mode_main(flag: str):
    def entry(argv=None) -> int:
        args = list(sys.argv[1:] if argv is None else argv)
        return main([flag] + args)
    return entry


# mode wrapper entry points (the reference's metaspades.py etc.)
main_meta = _mode_main("--meta")
main_plasmid = _mode_main("--plasmid")
main_metaplasmid = _mode_main("--metaplasmid")
main_metaviral = _mode_main("--metaviral")
main_rna = _mode_main("--rna")
main_rnaviral = _mode_main("--rnaviral")
main_corona = _mode_main("--corona")
main_truspades = _mode_main("--moleculo")


if __name__ == "__main__":
    raise SystemExit(main())
