"""The frozen roofline counts against hand-worked operands."""

import pytest
import torch

from mvbench import roofline


def test_advect():
    here = torch.zeros((2, 4, 4, 4))
    t_in = torch.zeros((2, 4, 4))
    # here in and out, t_in in; 10 operations a texel and slice
    assert roofline.bound_advect((here, t_in), {}) == (
        2 * 512 + 128, 10.0 * 128)


def test_self_scan():
    rho = torch.zeros((2, 4, 4, 4))
    assert roofline.bound_self_scan((rho, None, None, None), {}) == (
        2 * 512 + 2 * 16 * 4, 13.0 * 128)
    sm = torch.zeros((2, 4, 4))
    assert roofline.bound_self_scan((rho, None, None, None),
                                    {"sm_vol": sm}) == (
        2 * 512 + 2 * 16 * 4 * 2, 26.0 * 128)


def test_taa():
    cur, hist, blur = torch.zeros((4, 2, 3)), torch.zeros((4, 2, 3)), \
        torch.zeros((2, 3))
    assert roofline.bound_taa((cur, hist, blur), {}) == (
        (24 + 24 + 6) * 4 + 4 * 6 * 4, 780.0)
    assert roofline.bound_taa((cur, hist, blur), {"tonemap": True})[0] == \
        (24 + 24 + 6) * 4 + 7 * 6 * 4


def test_composite():
    """3 volumes of n_eff 2, 4 and 8; two tiles of 2 x 2 pixels listing
    volumes (0, 2) and (2,): 3 pairs a pixel, volumes 0 and 2 read."""
    color = torch.zeros((3, 6, 4, 8, 8))
    scene = torch.zeros((1, 2, 4))
    tlist = torch.tensor([[0, 2], [2, 0]], dtype=torch.int32)
    counts = torch.tensor([2, 1], dtype=torch.int32)
    vol_flt = torch.zeros((3, 24))
    vol_flt[:, 20] = torch.tensor([2.0, 4.0, 8.0])
    face_flt = torch.zeros((3, 6, 4))
    nbytes, flops = roofline.bound_composite(
        (color, scene, tlist, counts, vol_flt, face_flt, 2, 2), {})
    faces = (4 + 64) * 6 * 4 * 4
    operands = 4 * (8 + 4 + 2 + 72 + 72) + 4 * 8 * 4
    assert nbytes == faces + operands
    assert flops == 60.0 * 3 * 4


def test_least_time():
    assert roofline.least_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_s(0.0, 67e12) == pytest.approx(1.0)
    assert roofline.least_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
