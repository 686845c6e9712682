# -*- coding: utf-8 -*-
"""Which shapes the conv and block kernels take (``conv3x3.takes``,
``block.takes``), and the model layer's route of the rest to plain
PyTorch, counted in ``conv3x3.conv3x3.routed`` and
``block.basic_block.routed``, as the JAX package sends the shapes its
Pallas kernels do not take to XLA (``conv_pallas.enabled_for``,
``block_pallas.enabled_for``).

A truth table over every 3x3 conv and every BasicBlock of the U-Net at
width 16 and 8 (the UGAN towers' convs at width 16 are the U-Net's), and
every 3x3 conv of the discriminator at width 16, whose ``conv_src`` has
one output channel; the sites are read off the port's models, so a new
site without a row fails.  On the CPU the wrappers run their plain versions,
so the routes are counted here without a card."""
import numpy as np
import pytest
import torch

from smsut_tpu_torch.models import UNet
from smsut_tpu_torch.models.blocks import BasicBlock
from smsut_tpu_torch.models.layers import Conv
from smsut_tpu_torch.models.ugan import Discriminator, UGANnce
from smsut_tpu_torch.ops import block, conv3x3

BF16 = torch.bfloat16

# (Cin, Cout) of the U-Net's 3x3 convs -> whether K2 and K5 take the conv
CONVS = {
    16: {(8, 16): True, (16, 16): True, (16, 32): True, (32, 32): True,
         (32, 64): True, (64, 64): True, (64, 128): True, (128, 128): True,
         (128, 256): True, (256, 256): True, (256, 128): True,
         (128, 64): True, (64, 32): True, (32, 16): True},
    # the first block (4 -> 8, 8 -> 8) and the last (16 -> 8, 8 -> 8):
    # Cout 8 has no K5 tile, Cin 4 no dx tile
    8: {(4, 8): False, (8, 8): False, (8, 16): True, (16, 16): True,
        (16, 32): True, (32, 32): True, (32, 64): True, (64, 64): True,
        (64, 128): True, (128, 128): True, (128, 64): True, (64, 32): True,
        (32, 16): True, (16, 8): False},
}
# (Cin, Cout) of the discriminator's 3x3 convs at width 16 (256^2 input,
# max width 256, the GAN's D): its five BottleBlocks' convs, all taken,
# and conv_src (Cout 1), routed
D_CONVS = {(16, 32): True, (32, 32): True, (32, 64): True, (64, 64): True,
           (64, 128): True, (128, 128): True, (128, 256): True,
           (256, 256): True, (256, 1): False}
# (Cin, Cout) of the U-Net's BasicBlocks, all of the shortcut form
BLOCKS = {
    16: {(8, 16): True, (16, 32): True, (32, 64): True, (64, 128): True,
         (128, 256): True, (256, 128): True, (128, 64): True, (64, 32): True,
         (32, 16): True},
    8: {(4, 8): False, (8, 16): True, (16, 32): True, (32, 64): True,
        (64, 128): True, (128, 64): True, (64, 32): True, (32, 16): True,
        (16, 8): False},
}


def _sites(width):
    net = UNet(5, width, device="cpu")
    convs = {tuple(m.weight.shape[2:]) for m in net.modules()
             if isinstance(m, Conv) and m.weight.shape[0] == 3}
    blocks = {(m.conv1.weight.shape[2], m.conv1.weight.shape[3])
              for m in net.modules() if isinstance(m, BasicBlock)}
    return convs, blocks


@pytest.mark.parametrize("width", [16, 8])
def test_tables_cover_every_site(width):
    convs, blocks = _sites(width)
    assert convs == set(CONVS[width])
    assert blocks == set(BLOCKS[width])


def _convs(net):
    return {tuple(m.weight.shape[2:]) for m in net.modules()
            if isinstance(m, Conv) and m.weight.shape[0] == 3}


def test_gan_tables_cover_every_site():
    """The UGAN towers at width 16 have the U-Net's 3x3 convs; the
    discriminator's are D_CONVS."""
    assert _convs(UGANnce(5, 4, 16, device="cpu")) == set(CONVS[16])
    assert _convs(Discriminator(256, 4, 16, 256, device="cpu")) == set(
        D_CONVS)


@pytest.mark.parametrize("width,cin,cout,want",
                         [(w, ci, co, v) for w, t in CONVS.items()
                          for (ci, co), v in t.items()]
                         + [("D", ci, co, v)
                            for (ci, co), v in D_CONVS.items()]
                         + [(0, 64, 1, False)])
def test_conv3x3_takes(width, cin, cout, want):
    """Width "D": the discriminator's; 0: a ``conv_src`` at Cin 64."""
    for dt in (BF16, torch.float32):
        assert conv3x3.takes((8, 32, 32, cin), cout, dt) is want
    assert not conv3x3.takes((8, 32, 32, cin), cout, torch.float16)


@pytest.mark.parametrize("width,cin,cout,want",
                         [(w, ci, co, v) for w, t in BLOCKS.items()
                          for (ci, co), v in t.items()])
def test_block_takes(width, cin, cout, want):
    for dt in (BF16, torch.float32):
        assert block.takes((8, 32, 32, cin), cout, True, dt) is want
    assert not block.takes((8, 32, 32, cin), cout, True, torch.float16)


@pytest.mark.parametrize("cin,cout,want", [(64, 64, True), (16, 16, True),
                                           (8, 8, False), (64, 32, False)])
def test_block_takes_identity_form(cin, cout, want):
    """The identity form needs Cin == Cout, and the kernels' multiples."""
    assert block.takes((2, 16, 16, cin), cout, False, BF16) is want


@pytest.mark.parametrize("fused,convs,blocks", [(False, 4, 0), (True, 4, 2)])
def test_forward_counts_routed_calls(fused, convs, blocks):
    """A width-8 forward routes the first and last blocks' four 3x3 convs,
    and with ``block_fused`` those two blocks (whose unfused chains route
    the same convs); a width-16 forward routes nothing."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 32, 32, 1)).astype(np.float32))
    for width, want in ((8, (convs, blocks)), (16, (0, 0))):
        net = UNet(5, width, compute_dtype=torch.float32, block_fused=fused,
                   device="cpu")
        before = (conv3x3.conv3x3.routed, block.basic_block.routed)
        with torch.no_grad():
            y = net(x)
        got = (conv3x3.conv3x3.routed - before[0],
               block.basic_block.routed - before[1])
        assert got == want and bool(torch.isfinite(y).all())


def test_discriminator_forward_routes_conv_src():
    """A w16 discriminator forward routes its one Cout-1 conv and no
    other; so does its gradient penalty's double backward (the route is
    fixed at the forward)."""
    D = Discriminator(64, 4, 16, 256, compute_dtype=torch.float32,
                      device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 64, 64, 1)).astype(np.float32)).requires_grad_()
    before = conv3x3.conv3x3.routed
    src, _ = D(x)
    g, = torch.autograd.grad(src.sum(), x, create_graph=True)
    torch.autograd.grad(g.square().sum(), list(D.parameters()),
                        allow_unused=True)
    assert conv3x3.conv3x3.routed - before == 1
