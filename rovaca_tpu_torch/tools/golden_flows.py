"""The reference flows of ``tests/golden_torch/``.

The directory commits a 50 kb / 30x corpus (``sample.bam``, ``ref.fa``,
their indexes, the truth list), each flow's inputs (``targets.bed``,
``recal.table``, ``dbsnp.vcf.gz`` with its ``.tbi``), and for every flow
below the output that ``python -m rovaca_tpu.cli HaplotypeCaller
--pairhmm-engine xla`` made on it, xz-compressed, beside rovaca_tpu's VCF and
GVCF of the 1 Mb / 30x corpus (seed 424242) and of the adversarial corpus
(``tools.golden_adversarial``, seed 20260505), neither of which is
committed, only their hashes. ``MANIFEST.json`` gives each file's command,
seed, corpus arguments, engine and SHA-256.

``run_flow`` runs one flow through a CLI entry point with this package's
flags (``cli.main``, or rovaca_tpu's for the references) and returns its
output as text; ``diff_flow`` holds that to the committed reference with
``golden_e2e.diff`` (IDs included); ``effect_problems`` says whether the
flow did what it is for. chip_smoke.py runs them on the card, the tests on
the CPU.
"""

import contextlib
import dataclasses
import gzip
import hashlib
import json
import lzma
import os
import shutil
import zlib

from . import golden_e2e

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden_torch")
CORPUS = dict(genome_len=50_000, coverage=30, seed=424242)
CORPUS_1MB = dict(genome_len=1_000_000, coverage=30, seed=424242)
# tools.golden_adversarial.generate's corpus: three 150 kb contigs at 30x
CORPUS_ADVERSARIAL = dict(seed=20260505)
# the files a corpus not committed is pinned by, under the manifest's names
CORPUS_HASHED = ("ref.fa", "sample.bam payload", "truth.txt")
INTERVAL = ("chr20", 10_001, 30_000)       # the -L flow's span, 1-based
BED_PADDING = 100
# dbsnp.vcf.gz: truth sites under rs1000 + k; one truth site's row with
# another allele (DECOY_ID) and one truth site's row filtered (FILTERED_ID),
# neither of which may reach the output
DECOY_ID, FILTERED_ID = "rs2000", "rs3000"


@dataclasses.dataclass(frozen=True)
class Flow:
    """HaplotypeCaller arguments ("@name" is a file of the golden
    directory) and environment of one flow; ``two_bams`` splits sample.bam
    by read name into two BAMs; ``resume`` runs _resume's flow: a straight
    .vcf.gz, a copy whose checkpoint claims only a window before the
    contig, then --resume on the copy."""
    args: tuple = ()
    env: tuple = ()
    two_bams: bool = False
    resume: bool = False

    @property
    def gvcf(self):
        return "GVCF" in self.args


# the banded flows force the banded realignment: on the CPU engines it runs
# K3's plain versions instead of the native SW batch; on cuda every flow
# runs K3, since the card is the gate's default
_BANDED = (("ROVACA_BANDED_REALIGN", "1"),)
_GVCF = ("-e", "GVCF")
FLOWS = {
    "vcf": Flow(),
    "gvcf": Flow(_GVCF),
    "banded_vcf": Flow(env=_BANDED),
    "banded_gvcf": Flow(_GVCF, env=_BANDED),
    "bqsr": Flow(("--bqsr-recal-table", "@recal.table")),
    "bed": Flow(("-b", "@targets.bed", "-P", str(BED_PADDING))),
    "dbsnp": Flow(("-d", "@dbsnp.vcf.gz")),
    "resume": Flow(resume=True),
    "two_bams": Flow(two_bams=True),
    "interval": Flow(("-L", f"{INTERVAL[0]}:{INTERVAL[1]}-{INTERVAL[2]}")),
    "pcr_none": Flow(("--pcr-indel-model", "NONE")),
    "gq_bands": Flow(_GVCF + ("--gq-bands", "5,20,60")),
}


def reference_name(name):
    return f"{name}.g.vcf.xz" if FLOWS[name].gvcf else f"{name}.vcf.xz"


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def sha256_bam_payload(path):
    """SHA-256 of a BAM's decompressed BGZF payload, which no zlib version
    changes."""
    h = hashlib.sha256()
    with gzip.open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def load_manifest(golden=GOLDEN_DIR):
    with open(os.path.join(golden, "MANIFEST.json")) as f:
        return json.load(f)


def manifest_problems(golden=GOLDEN_DIR):
    """Committed files whose SHA-256 is not the manifest's, or missing."""
    bad = []
    for name, entry in load_manifest(golden)["files"].items():
        path = os.path.join(golden, name)
        if not os.path.exists(path):
            bad.append(f"{name}: missing")
        elif sha256_file(path) != entry["sha256"]:
            bad.append(f"{name}: SHA-256 differs from the manifest's")
    return bad


def corpus_hashes(workdir, names=CORPUS_HASHED):
    """SHA-256 of a corpus's files ``names`` (the manifest's names: a BAM
    by its payload, as "<name>.bam payload")."""
    return {k: sha256_bam_payload(os.path.join(workdir, k[:-len(" payload")]))
            if k.endswith(" payload")
            else sha256_file(os.path.join(workdir, k)) for k in names}


def corpus_problems(workdir, key, golden=GOLDEN_DIR):
    """A generated corpus whose files are not the ones the committed
    references were made from (a stale corpus, not a port that diverges):
    each hash the manifest's ``key`` entry pins ("corpus_1mb": ref.fa and
    the BAM payload; "corpus_adversarial": truth.txt too; the tools'
    corpora their inputs as well)."""
    want = load_manifest(golden)[key]
    got = corpus_hashes(workdir, [k for k in want
                                  if k not in ("args", "command")])
    return [f"{k}: {got[k]} against the manifest's {want[k]}"
            for k in got if got[k] != want[k]]


def unpack_reference(name, path, golden=GOLDEN_DIR):
    """Decompress a committed reference (``name`` as in the manifest) to
    ``path``."""
    with lzma.open(os.path.join(golden, name), "rb") as src, \
            open(path, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return path


def split_bam(bam, out_dir):
    """sample.bam's records split by read name (CRC-32 parity, so mates
    stay together) into two indexed BAMs with the same header."""
    from ..io.bai import build_index
    from ..io.bam import BamReader, BamWriter
    paths = [os.path.join(out_dir, f"part{k}.bam") for k in range(2)]
    reader = BamReader(bam)
    with BamWriter(paths[0], reader.header) as a, \
            BamWriter(paths[1], reader.header) as b:
        for read in reader:
            (b if zlib.crc32(read.name.encode()) & 1 else a).write(read)
    reader.close()
    for p in paths:
        build_index(p)
    return paths


@contextlib.contextmanager
def _environ(pairs):
    old = {k: os.environ.get(k) for k, _ in pairs}
    os.environ.update(pairs)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_flow(cli, name, out_dir, engine, golden=GOLDEN_DIR):
    """Run flow ``name`` through ``cli`` (argv -> exit code) into
    ``out_dir``. Returns {"output": the output as text, "commands": the
    argv of each run, paths relative to ``golden`` and ``out_dir``, and
    for the resume flow "straight": the straight run's text, "bgzf": the
    resumed .vcf.gz}."""
    flow = FLOWS[name]
    os.makedirs(out_dir, exist_ok=True)
    bam = os.path.join(golden, "sample.bam")
    bams = split_bam(bam, out_dir) if flow.two_bams else [bam]
    base = (["HaplotypeCaller"] + [x for b in bams for x in ("-i", b)]
            + ["-r", os.path.join(golden, "ref.fa")]
            + [os.path.join(golden, a[1:]) if a.startswith("@") else a
               for a in flow.args]
            + ["--pairhmm-engine", engine, "--log-level", "WARNING"])
    commands = []

    def run(out, *extra):
        argv = base + ["-o", out, *extra]
        commands.append([os.path.relpath(a, golden) if a.startswith(golden)
                         else os.path.relpath(a, out_dir)
                         if a.startswith(out_dir) else a for a in argv])
        with _environ(flow.env):
            rc = cli(argv)
        if rc != 0:
            raise RuntimeError(f"flow {name}: {argv} exited {rc}")

    suffix = ".g.vcf" if flow.gvcf else ".vcf"
    text = os.path.join(out_dir, name + suffix)
    if not flow.resume:
        run(text)
        return {"output": text, "commands": commands}
    full = os.path.join(out_dir, f"{name}_full.vcf.gz")
    run(full)
    part = os.path.join(out_dir, f"{name}.vcf.gz")
    shutil.copy(full, part)
    with open(part + ".progress", "w") as fh:
        json.dump({"contigs": {"chr20": -(1 << 20)}}, fh)
    run(part, "--resume")
    straight = os.path.join(out_dir, f"{name}_full.vcf")
    for src, dst in ((full, straight), (part, text)):
        with gzip.open(src, "rb") as a, open(dst, "wb") as b:
            shutil.copyfileobj(a, b)
    return {"output": text, "straight": straight, "commands": commands,
            "bgzf": part}


def diff_flow(name, output, workdir, golden=GOLDEN_DIR):
    """golden_e2e.diff of a flow's output against its committed reference
    (IDs included), in ``workdir``; 0 when they match."""
    return diff_against(output, reference_name(name), workdir,
                        FLOWS[name].gvcf, golden)


def diff_against(output, reference, workdir, gvcf, golden=GOLDEN_DIR):
    """golden_e2e.diff of ``output`` against the committed ``reference``."""
    os.makedirs(workdir, exist_ok=True)
    ours = os.path.join(workdir, "ours.g.vcf" if gvcf else "ours.vcf")
    if os.path.abspath(output) != ours:
        shutil.copy(output, ours)
    unpack_reference(reference, os.path.join(
        workdir, "ref.g.vcf" if gvcf else "ref.vcf"), golden)
    return golden_e2e.diff(workdir, gvcf=gvcf, check_id=True)


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#")]


def banded_realign(name, engine):
    """Do flow ``name``'s runs on ``engine`` realign on the banded path?
    The realignment gate (``use_banded_sw``) under the flow's environment,
    for the engine's device: the card for cuda and auto, else the CPU."""
    from ..genotype.alignment_utils import use_banded_sw
    with _environ(FLOWS[name].env):
        return use_banded_sw("cuda" if engine in ("cuda", "auto") else "cpu")


def effect_problems(name, result, golden=GOLDEN_DIR, engine=None,
                    sw_launches=()):
    """Why flow ``name``'s ``result`` (run_flow's) shows the flow did
    nothing, or []: BED calls only inside targets.bed +- BED_PADDING, -L
    only inside its span, dbSNP IDs on the truth sites and neither the
    decoy's nor the filtered record's, BQSR records not the plain VCF
    reference's, --resume the straight run's records in a file that ends
    in the BGZF EOF block; given ``engine`` and each run's
    ``sw_launches`` (its banded batches), every run realigned on the
    banded path exactly when ``banded_realign`` says it should."""
    from ..io import bgzf
    records, _ = golden_e2e.parse_vcf(result["output"])
    if not records:
        return [f"{name}: no records"]
    want = banded_realign(name, engine)
    if any((n > 0) != want for n in sw_launches):
        return [f"{name}: banded batches {list(sw_launches)} on {engine}, "
                f"expected {'some' if want else 'none'} in every run"]
    pos = sorted(k[1] for k in records)
    if name == "bed":
        with open(os.path.join(golden, "targets.bed")) as f:
            spans = [(int(b) - BED_PADDING, int(e) + BED_PADDING)
                     for _, b, e in (ln.split()[:3] for ln in f)]
        out = [p for p in pos if not any(b < p <= e for b, e in spans)]
        return [f"bed: records outside the targets: {out[:5]}"] if out else []
    if name == "interval":
        out = [p for p in pos if not INTERVAL[1] <= p <= INTERVAL[2]]
        return [f"interval: records outside -L: {out[:5]}"] if out else []
    if name == "dbsnp":
        ids = {r["id"] for r in records.values() if r["id"] != "."}
        bad = ids & {DECOY_ID, FILTERED_ID}
        truth = {i for i in ids if i.startswith("rs1")}
        if bad or not truth:
            return [f"dbsnp: IDs {sorted(ids)}"]
        return []
    if name == "bqsr":
        plain = unpack_reference(reference_name("vcf"), os.path.join(
            os.path.dirname(result["output"]), "plain_reference.vcf"), golden)
        if _records(plain) == _records(result["output"]):
            return ["bqsr: the records equal the plain run's"]
        return []
    if name == "resume":
        with open(result["bgzf"], "rb") as f:
            f.seek(-len(bgzf.EOF_BLOCK), os.SEEK_END)
            eof = f.read() == bgzf.EOF_BLOCK
        same = _records(result["straight"]) == _records(result["output"])
        return ([] if eof else ["resume: no BGZF EOF block"]) + (
            [] if same else ["resume: records differ from the straight run"])
    return []
