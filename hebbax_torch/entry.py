"""The repo's 29 root entry points (``train_semi_EM_2d.py``,
``test_DTC.py``, ...) on the port: for each, the CLI module under
:mod:`hebbax_torch.cli` that its root shim calls, the positional algo or
kind the shim passes to ``main``, and the flags the shim appends unless
the caller gave them.

    python -m hebbax_torch.entry train_semi_EM_2d [flags]
    python -m hebbax_torch.entry test_DTC.py --path_exp <run>

:func:`run` passes ``loaders=`` and the like on to the CLI's ``main``;
:func:`parse` returns the ``Namespace`` the entry point would run with.
:mod:`hebbax_torch.sweep` runs the ``reproduce_*.sh`` sweeps through it.
"""

import importlib
import sys
from typing import NamedTuple, Optional, Tuple


class Entry(NamedTuple):
    module: str                 # under hebbax_torch.cli
    arg: Optional[str] = None   # main's positional algo / kind
    # ((flag, *aliases), value): ``flag value`` is appended unless the
    # argv holds one of the flags as a word of its own (the shims' test)
    defaults: Tuple = ()


ENTRIES = {
    "pretrain_hebbian_unsup_2d": Entry("pretrain_hebbian_unsup_2d"),
    "pretrain_hebbian_unsup_3d": Entry("pretrain_hebbian_unsup_3d"),
    "pretrain_superdiff3d_unsup_3d": Entry("pretrain_unsup_3d", "superdiff"),
    "pretrain_superdiff_unsup_2d": Entry("pretrain_unsup_2d", "superdiff"),
    "pretrain_superdiff_unsup_3d": Entry("pretrain_unsup_3d", "superdiff"),
    "pretrain_superpix_unsup_2d": Entry("pretrain_unsup_2d", "superpix"),
    "pretrain_superpix_unsup_3d": Entry("pretrain_unsup_3d", "superpix"),
    "pretrain_vae_unsup_2d": Entry("pretrain_unsup_2d", "vae"),
    "pretrain_vae_unsup_3d": Entry("pretrain_unsup_3d", "vae"),
    "test_2d": Entry("test_2d"),
    "test_3d": Entry("test_3d"),
    # --dp_devices 0: every visible card
    "test_DTC": Entry("test_3d", None, ((("--network", "-n"), "vnet_dtc"),
                                        (("--dp_devices",), "0"))),
    "test_raddino_decoder_2d": Entry("test_raddino_decoder_2d"),
    "test_snn_2d": Entry("test_2d", None,
                         ((("--network", "-n"), "snn_vgg"),)),
    "train_semi_CCT_2d": Entry("train_semi_2d", "cct"),
    "train_semi_CCT_3d": Entry("train_semi_3d", "cct"),
    "train_semi_CPS_2d": Entry("train_semi_2d", "cps"),
    "train_semi_CPS_3d": Entry("train_semi_3d", "cps"),
    "train_semi_DTC_3d": Entry("train_semi_3d", "dtc"),
    "train_semi_EM_2d": Entry("train_semi_2d", "em"),
    "train_semi_EM_3d": Entry("train_semi_3d", "em"),
    "train_semi_UAMT_2d": Entry("train_semi_2d", "uamt"),
    "train_semi_UAMT_3d": Entry("train_semi_3d", "uamt"),
    "train_semi_URPC_2d": Entry("train_semi_2d", "urpc"),
    "train_semi_URPC_3d": Entry("train_semi_3d", "urpc"),
    "train_semi_raddino_decoder_2d": Entry("train_semi_raddino_decoder_2d"),
    "train_snn_sup_2d": Entry("train_snn_sup_2d"),
    "train_sup_2d": Entry("train_sup_2d"),
    "train_sup_3d": Entry("train_sup_3d"),
}


class UnknownEntry(ValueError):
    pass


def resolve(name):
    """``name`` or ``name.py`` -> (the bare name, its :class:`Entry`)."""
    key = name[:-3] if name.endswith(".py") else name
    if key not in ENTRIES:
        raise UnknownEntry(f"{name!r} is not one of the repo's "
                           f"{len(ENTRIES)} root entry points")
    return key, ENTRIES[key]


def with_defaults(entry, argv):
    """``argv`` with the entry's injected flags appended, as its shim
    does."""
    argv = list(argv)
    for flags, value in entry.defaults:
        if not any(f in argv for f in flags):
            argv += [flags[0], value]
    return argv


def _cli(entry):
    mod = importlib.import_module(f"{__package__}.cli.{entry.module}")
    return mod, (() if entry.arg is None else (entry.arg,))


def build_parser(name):
    """The port's parser of entry point ``name`` (without its injected
    flags)."""
    mod, pos = _cli(resolve(name)[1])
    return mod.build_parser(*pos)


def parse(name, argv=(), parser=None):
    """The ``Namespace`` entry point ``name`` runs with on ``argv``;
    ``parser``: one :func:`build_parser` made for it, reused."""
    entry = resolve(name)[1]
    parser = parser or build_parser(name)
    return parser.parse_args(with_defaults(entry, argv))


def run(name, argv=(), **kw):
    """Run entry point ``name`` on ``argv``; ``kw`` (``loaders=``,
    ``loader=``, ...) go to the CLI's ``main``.  Returns what it
    returns."""
    entry = resolve(name)[1]
    mod, pos = _cli(entry)
    return mod.main(*pos, with_defaults(entry, argv), **kw)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        sys.exit(f"usage: python -m hebbax_torch.entry <entry point>[.py] "
                 f"[flags]; entry points: {' '.join(sorted(ENTRIES))}")
    try:
        resolve(argv[0])
    except UnknownEntry as e:
        sys.exit(f"hebbax_torch.entry: {e}")
    return run(argv[0], argv[1:])


if __name__ == "__main__":
    main()
