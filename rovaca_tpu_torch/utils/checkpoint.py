"""Checkpointable shard progress (an improvement over the reference, which
has none — SURVEY section 5.4: restart granularity is the whole invocation).

A sidecar JSON next to the output records the last fully-emitted window per
contig. On resume, completed windows are skipped and the output is appended
after truncating any partial tail records.
"""

import json
import os


class ProgressCheckpoint:
    def __init__(self, output_path):
        self.path = output_path + ".progress"
        self.state = {"contigs": {}}
        if os.path.exists(self.path):
            try:
                with open(self.path) as fh:
                    self.state = json.load(fh)
            except (json.JSONDecodeError, OSError):
                self.state = {"contigs": {}}

    def completed_through(self, contig):
        """Last window-start fully emitted for contig, or -1."""
        return self.state["contigs"].get(contig, -1)

    def mark_window(self, contig, win_start):
        self.state["contigs"][contig] = max(
            self.state["contigs"].get(contig, -1), win_start)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.state, fh)
        os.replace(tmp, self.path)

    def finish(self):
        if os.path.exists(self.path):
            os.unlink(self.path)


def truncate_output_after(path, contig, max_start):
    """Drop records of `contig` past `max_start` (1-based positions in the
    file; max_start is a 0-based window bound) so a resumed run can append
    without duplicates. Returns number of kept records."""
    with open(path, "rb") as probe:
        is_gz = probe.read(2) == b"\x1f\x8b"
    kept = []
    n = 0
    if is_gz:
        import io

        from ..io import bgzf
        fh = io.TextIOWrapper(bgzf.open_read(path))
    else:
        fh = open(path)
    with fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.split("\t", 2)
                if f[0] == contig and int(f[1]) - 1 >= max_start:
                    continue
                n += 1
            kept.append(line)
    if is_gz:
        from ..io import bgzf
        with bgzf.Writer(path) as w:
            w.write("".join(kept).encode())
    else:
        with open(path, "w") as fh:
            fh.writelines(kept)
    return n
