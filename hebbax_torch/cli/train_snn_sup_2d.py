"""Supervised training of the spiking VGG9 (the root shim
``train_snn_sup_2d.py`` over ``hebbax/cli/train_sup_2d.py``): the
supervised 2D trainer (:mod:`hebbax_torch.cli.train_sup_2d`) with
``--network snn_vgg`` by default (``-n ann_vgg`` trains the non-spiking
twin).

    python -m hebbax_torch.cli.train_snn_sup_2d --regime 10 ...

Run dirs: ``<root>/<dataset>/semi_sup/kaiming_snn_vgg/inv_temp-1/
regime-R/run-S`` below regime 100, ``fully_sup/snn_vgg/...`` at 100.
The Poisson input draws from seed+4.
"""

from . import common
from .common import base_parser_2d
from .train_sup_2d import add_args, build


def main(argv=None, loaders=None):
    parser = add_args(base_parser_2d({"network": "snn_vgg"}))
    args = parser.parse_args(argv)
    return common.train(build, args, loaders)


if __name__ == "__main__":
    main()
