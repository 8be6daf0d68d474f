"""Run one of the repo's ``reproduce_*.sh`` sweeps on the port.

    python -m hebbax_torch.sweep reproduce_hebbian_semi_supervised_2d.sh
    python -m hebbax_torch.sweep reproduce_X.sh --record [FILE]

The script runs unchanged under ``bash`` in its own directory (the
sweeps read ``./data`` and write ``./runs``), with ``PATH`` led by a
temporary directory whose ``python`` is written here:

* run mode: that ``python`` runs ``<this interpreter> -m
  hebbax_torch.entry "$@"``, so each ``python <shim>.py ...`` line of the
  sweep runs that root entry point on the port (:mod:`hebbax_torch.entry`).
  A line whose first word is not one of the entry points stops with an
  error naming it, and the sweep's ``set -e`` ends it there.
* record mode: that ``python`` only appends its arguments, NUL-separated
  after their count, to a file and exits 0, so bash expands the whole
  sweep in seconds, its word splitting included.  Every recorded line is
  then resolved and parsed with the port's parsers in this process, and
  the count of lines per entry point printed; ``FILE`` (``-`` or none:
  standard output) receives the lines, shell-quoted, one per line.  A
  line that names an earlier line's output is recorded as it reads.

The exit status is the sweep's (run mode), or non-zero when a recorded
line names no entry point or does not parse.
"""

import argparse
import os
import shlex
import stat
import subprocess
import sys
import tempfile
from collections import Counter

from . import entry

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = """#!/bin/sh
case "$1" in
  {names}) ;;
  *) echo "hebbax_torch.sweep: 'python $1' is not one of the repo's \
{n} root entry points" >&2; exit 2 ;;
esac
exec {python} -m hebbax_torch.entry "$@"
"""

_RECORD_BODY = """printf '%s\\0' "$#" "$@" >> {path}"""


def _write_python(bindir, text):
    path = os.path.join(bindir, "python")
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP
             | stat.S_IXOTH)


def _bash(script, bindir, env=None, **kw):
    env = dict(os.environ if env is None else env)
    env["PATH"] = bindir + os.pathsep + env.get("PATH", "")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
    script = os.path.abspath(script)
    return subprocess.run(["bash", script], cwd=os.path.dirname(script),
                          env=env, **kw)


def run(script, env=None):
    """Run ``script`` through the entry points; returns bash's exit
    status."""
    names = sorted(entry.ENTRIES)
    with tempfile.TemporaryDirectory() as bindir:
        _write_python(bindir, _RUN.format(
            names="|".join(n for name in names for n in (name,
                                                         name + ".py")),
            n=len(names), python=shlex.quote(sys.executable)))
        return _bash(script, bindir, env).returncode


def _split_records(blob):
    words = blob.split(b"\0")[:-1]
    lines, i = [], 0
    while i < len(words):
        n = int(words[i])
        lines.append([w.decode() for w in words[i + 1:i + 1 + n]])
        i += 1 + n
    return lines


def record(script, env=None):
    """The argument lists of every ``python`` line ``script`` runs, in
    order, without running any."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lines")
        open(out, "wb").close()
        body = _RECORD_BODY.format(path=shlex.quote(out))
        _write_python(tmp, "#!/bin/sh\n" + body + "\n")
        env = dict(os.environ if env is None else env)
        # the same body as an exported bash function, which bash runs
        # before any ``python`` on PATH without starting a process
        env["BASH_FUNC_python%%"] = "() { " + body + "; }"
        proc = _bash(script, tmp, env, stdout=subprocess.DEVNULL,
                     stderr=subprocess.PIPE)
        if proc.returncode:
            raise RuntimeError(f"{script}: bash exited {proc.returncode} in "
                               f"record mode: {proc.stderr.decode()[-2000:]}")
        with open(out, "rb") as f:
            return _split_records(f.read())


class LineError(ValueError):
    pass


def parse_lines(lines):
    """``[(entry name, Namespace)]`` of recorded lines, one parser per
    entry point; raises :class:`LineError` naming the first line that
    names no entry point or does not parse."""
    parsers, out = {}, []
    for i, words in enumerate(lines):
        line = shlex.join(["python"] + words)
        if not words:
            raise LineError(f"line {i + 1}: {line!r} names no entry point")
        try:
            name = entry.resolve(words[0])[0]
        except entry.UnknownEntry as e:
            raise LineError(f"line {i + 1}: {line!r}: {e}") from None
        if name not in parsers:
            parsers[name] = entry.build_parser(name)
        try:
            ns = entry.parse(name, words[1:], parsers[name])
        except SystemExit:
            raise LineError(f"line {i + 1}: {line!r} does not parse") \
                from None
        out.append((name, ns))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m hebbax_torch.sweep",
        description="Run a reproduce_*.sh sweep through the port's entry "
                    "points, or --record its lines without running them.")
    p.add_argument("script")
    p.add_argument("--record", nargs="?", const="-", default=None,
                   metavar="FILE", help="record and parse the sweep's lines "
                   "instead of running them; list them in FILE (- or "
                   "none: standard output)")
    args = p.parse_args(argv)
    if args.record is None:
        return run(args.script)
    lines = record(args.script)
    try:
        parsed = parse_lines(lines)
    except LineError as e:
        print(f"hebbax_torch.sweep: {args.script}: {e}", file=sys.stderr)
        return 1
    text = "".join(shlex.join(["python"] + w) + "\n" for w in lines)
    if args.record == "-":
        sys.stdout.write(text)
    else:
        with open(args.record, "w") as f:
            f.write(text)
    report = sys.stderr if args.record == "-" else sys.stdout
    counts = Counter(name for name, _ in parsed)
    for name in sorted(counts):
        print(f"{counts[name]:8d}  {name}", file=report)
    print(f"{len(parsed):8d}  lines in {args.script}, every one parsed",
          file=report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
