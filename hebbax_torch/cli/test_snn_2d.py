"""Test-set evaluation of a spiking VGG9 run (the root shim
``test_snn_2d.py`` over ``hebbax/cli/test_2d.py``): the 2D tester
(:mod:`hebbax_torch.cli.test_2d`) with ``--network snn_vgg`` unless
``-n`` / ``--network`` is given.  The Poisson input draws from seed+4.

    python -m hebbax_torch.cli.test_snn_2d --path_exp <run> --best JI
"""

import sys

from .test_2d import main as test_main


def main(argv=None, loader=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--network" not in argv and "-n" not in argv:
        argv += ["--network", "snn_vgg"]
    return test_main(argv, loader)


if __name__ == "__main__":
    main()
