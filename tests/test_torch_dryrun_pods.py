"""The port's dry run on a fake 2 x 2 x 2 (pod, data, model) mesh: every
arch at its reduced config and reduced shapes (``test_torch_dryrun.py``
has the rest), each applicable cell ``ok`` with the reference's report
keys and parameter counts, the parameters' bytes a device equal to the 2 x
2 twin's (replicated over the pods) and, in training, an all-reduce over
the pods of every gradient."""
import pytest

from repro_torch.configs import list_archs
from torch_dryrun_cells import check_pod_cells


@pytest.mark.parametrize("arch", list_archs())
def test_reduced_cells_report_ok_on_pods(arch, tmp_path):
    check_pod_cells(arch, tmp_path)
