"""The port's data parallelism on 2 gloo CPU ranks: the Hebbian delta
merge (swta_t, hpca), CPS, UAMT, DTC and the float64 forward loss, held
against hebbax's step over ``make_mesh(2)`` and against the port's single
process on the same padded batch (3 samples padded to 4).  The cases,
their draws and tolerances are ``test_torch_parallel.py``'s (its module
docstring)."""

import pytest

from test_torch_parallel import (cps_case, check_case, dtc_case, f64_case,
                                 hebb_case, run_group, uamt_case)

GROUP = {"swta_t": lambda: hebb_case("swta_t", 2),
         "hpca": lambda: hebb_case("hpca", 2),
         "cps": lambda: cps_case(2),
         "uamt": lambda: uamt_case(2),
         "dtc": lambda: dtc_case(2),
         "f64": lambda: f64_case(2)}


@pytest.fixture(scope="module")
def runs():
    return run_group(GROUP, 2)


@pytest.mark.parametrize("name", list(GROUP))
def test_two_ranks_match_one_process_and_hebbax(runs, name):
    check_case(*runs[name])
