"""The plain textured K4 against kytpu's and the port's K3 on the 4x4
atlas (kytpu's select chain) at depth 1; setup and bounds as in
test_torch_texture_replay.py."""

from tests.test_torch_texture_replay import check_replay


def test_textured_k4_matches_kytpu_select_chain():
    check_replay("img4", depth=1)
