"""The plain textured K4 against kytpu's and the port's K3 on the 16x16
atlas (kytpu's separable route); setup and bounds as in
test_torch_texture_replay.py."""

from tests.test_torch_texture_replay import check_replay


def test_textured_k4_matches_kytpu_separable():
    check_replay("img16")
