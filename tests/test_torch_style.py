"""The port's AdaIN style enhancement (simple_sfod_tpu_torch/models/
style_transfer.py and the adaptation trainer's STYLE.* view) against the
JAX package's, on the CPU in float32.

Tolerances:
  adaptive_instance_normalization, coral   1e-5 (absolute, on unit-scale
                                           inputs; CORAL's 3x3 powers by
                                           Jacobi rotations in float64
                                           against JAX's SVD)
  the style resize                         1e-5 on [0, 1], up (the 64x64
                                           gray fallback style to the
                                           canvas) and down (a style larger
                                           than the canvas: JAX's
                                           antialiasing triangle kernel)
  encoder, decoder                         1e-5 of the output's largest entry
  stylize                                  1e-3 on the 0-255 scale, the
                                           style resized in both directions
  the .pth import                          exact, against the JAX importer
  the 1-step SFAT style lockstep           test_torch_sfat_trainer.py's
                                           bounds (num_pseudo and the counts
                                           equal, losses 1e-4 relative, the
                                           student by the movement rule)

Pinned departures of the reference:
  - the value range (followed): the JAX package scales the content to
    [0, 1] for the AdaIN nets and the output back by 255, where the
    reference feeds raw 0-255 pixels and takes the output unscaled;
  - `ENHANCE` is dead in both packages: only STYLE.ENABLED selects the
    style view (simple_sfod_tpu/config/defaults.py:227);
  - CORAL of a constant style (the flat-gray fallback): JAX's float32 mean
    of a constant leaves a residue that the 1e-8 std whitens into an
    offset; the port gives the targets' channel means exactly.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from simple_sfod_tpu.checkpoint import torch_import as jax_import
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu.models import style_transfer as js
from simple_sfod_tpu_torch.checkpoint.checkpointer import load_torch_weights
from simple_sfod_tpu_torch.checkpoint.from_jax import teacher_student_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import config_opts
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.models import style_transfer as ps
from simple_sfod_tpu_torch.models.faster_rcnn import anchor_counts, roi_pool_size
from test_torch_sfat_trainer import (
    BATCH,
    LOCKSTEP_OPTS,
    batches,
    bn_fed_bias,
    boost,
    inert_bias_ok,
    jax_adapt_draws,
    jax_closure,
    within_tolerance,
)
from test_torch_fpn import jit_jax_detector_init
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)
from test_torch_trainer import rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENHANCE_YAML = os.path.join(ROOT, "configs", "faster_rcnn_VGG_cityscapes_foggy_enhance.yaml")
CANVAS = (64, 128)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def chw(x):
    return T(np.asarray(x).transpose(2, 0, 1))


def nchw(x):
    return T(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def style_vars():
    """The flax encoder's and decoder's params at their init's shapes, filled
    with seeded values (kernels normal with std 1/sqrt(fan_in), biases
    normal(0, 0.01)), and the port's state dicts of them."""
    rs = np.random.RandomState(0)

    def filled(shapes):
        def fill(path, leaf):
            if str(getattr(path[-1], "key", path[-1])) == "kernel":
                return rs.normal(0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
            return rs.normal(0, 0.01, leaf.shape).astype(np.float32)
        return jax.tree_util.tree_map_with_path(fill, dict(shapes))

    ev = filled(jax.eval_shape(lambda: js.StyleEncoder().init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))))
    dv = filled(jax.eval_shape(lambda: js.StyleDecoder().init(jax.random.key(0), jnp.zeros((1, 4, 4, 512)))))
    esd, dsd = ps.style_state_from_jax(ev["params"], dv["params"])
    return ev, dv, esd, dsd


def test_adain_and_coral_against_jax():
    rs = np.random.RandomState(1)
    c, s = rs.randn(2, 8, 8, 4).astype(np.float32), (2 + 3 * rs.randn(2, 6, 6, 4)).astype(np.float32)
    want = np.asarray(js.adaptive_instance_normalization(jnp.asarray(c), jnp.asarray(s)))
    got = nhwc(ps.adaptive_instance_normalization(nchw(c), nchw(s)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    src, tgt = rs.rand(20, 24, 3).astype(np.float32), rs.rand(2, 16, 32, 3).astype(np.float32)
    tgt[1] = np.clip(0.5 + 0.1 * rs.randn(16, 32, 3), 0, 1)
    want = np.stack([np.asarray(js.coral(jnp.asarray(src), jnp.asarray(t))) for t in tgt])
    got = nhwc(ps.coral(chw(src), nchw(tgt)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the 3x3 powers: Jacobi against float64 eigh
    cov = T(np.stack([np.cov(rs.rand(3, 50)) * 50 + np.eye(3) for _ in range(3)]))
    w, v = torch.linalg.eigh(cov.double())
    for p in (-0.5, 0.5):
        ref = (v * w.pow(p)[:, None, :]) @ v.transpose(1, 2)
        assert torch.allclose(ps.spd_power(cov.float(), p).double(), ref, rtol=1e-6, atol=1e-7)


def test_coral_of_a_constant_style_is_the_target_mean():
    """The flat-gray fallback: the port recolours to each target's channel
    means exactly; JAX's float32 mean of the constant leaves a residue (its
    std is not 0) that it whitens into an offset (pinned, not copied)."""
    gray = np.full((64, 64, 3), 0.6, np.float32)
    tgt = np.random.RandomState(2).rand(2, 16, 32, 3).astype(np.float32)
    got = nhwc(ps.coral(chw(gray), nchw(tgt)))
    np.testing.assert_allclose(got, np.broadcast_to(tgt.mean(axis=(1, 2))[:, None, None], got.shape), atol=1e-6)
    x = jnp.asarray(gray).reshape(-1, 3).T
    assert float(jnp.std(x, axis=1, ddof=1).max()) > 0  # the residue JAX whitens
    want = np.stack([np.asarray(js.coral(jnp.asarray(gray), jnp.asarray(t))) for t in tgt])
    assert np.abs(want - got).max() > 1e-3


@pytest.mark.parametrize("src_hw,out_hw", [((64, 64), (64, 128)), ((64, 64), (128, 256)), ((150, 290), (64, 128)),
                                           ((45, 63), (64, 128))])
def test_resize_against_jax(src_hw, out_hw):
    x = np.random.RandomState(3).rand(2, *src_hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), "bilinear"))
    got = nhwc(ps.resize_bilinear_like_jax(nchw(x), out_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if out_hw[0] < src_hw[0]:  # downsampling: JAX antialiases, plain bilinear does not
        plain = nhwc(torch.nn.functional.interpolate(nchw(x), size=out_hw, mode="bilinear", align_corners=False))
        assert np.abs(plain - want).max() > 1e-2


def test_encoder_decoder_and_stylize_under_carried_weights(style_vars):
    ev, dv, esd, dsd = style_vars
    rs = np.random.RandomState(4)
    x = rs.rand(2, 40, 56, 3).astype(np.float32)
    enc, dec = ps.StyleEncoder(), ps.StyleDecoder()
    enc.load_state_dict(esd, strict=True)
    dec.load_state_dict(dsd, strict=True)
    f_want = np.asarray(jax.jit(js.StyleEncoder().apply)(ev, jnp.asarray(x)))
    with torch.no_grad():
        f_got = enc(nchw(x))
    assert np.abs(nhwc(f_got) - f_want).max() <= 1e-5 * np.abs(f_want).max()
    d_want = np.asarray(jax.jit(js.StyleDecoder().apply)(dv, jnp.asarray(f_want)))
    with torch.no_grad():
        d_got = dec(nchw(f_want))
    assert np.abs(nhwc(d_got) - d_want).max() <= 1e-5 * np.abs(d_want).max()

    content = rs.uniform(0, 255, (2, *CANVAS, 3)).astype(np.float32)
    # the style resized up to the canvas with CORAL, and down without it
    for style_hw, use_coral in (((64, 64), True), ((150, 290), False)):
        style = rs.rand(*style_hw, 3).astype(np.float32)
        st = js.StyleTransfer(ev, dv, jnp.asarray(style), use_coral=use_coral)
        want = np.asarray(jax.jit(st.stylize)(jnp.asarray(content)))
        pst = ps.load_style_transfer(chw(style), esd, dsd, 0.4, 0, use_coral=use_coral)
        got = pst.stylize(T(content))
        assert got.dtype == torch.float32 and not got.requires_grad
        assert np.abs(got.numpy() - want).max() <= 1e-3, (style_hw, use_coral)
        assert 0.0 <= got.min() and got.max() <= 255.0 and got.max() > 1.0


def test_stylize_value_range_deviation_followed(style_vars):
    """As the JAX package: content / 255 into the encoder and the decoder's
    output clipped to [0, 1] times 255; not the reference's raw 0-255
    input and unscaled output."""
    _, _, esd, dsd = style_vars
    rs = np.random.RandomState(5)
    content = T(rs.uniform(0, 255, (1, *CANVAS, 3)).astype(np.float32))
    style = chw(rs.rand(*CANVAS, 3).astype(np.float32))
    dsd = {**dsd, "out.bias": torch.full((3,), 0.5)}  # a mid-gray output, as trained weights give
    st = ps.load_style_transfer(style, esd, dsd, 0.4, 0, use_coral=False)
    got = st.stylize(content)
    with torch.no_grad():
        def blend(x):
            f_c, f_s = st.encoder(x), st.encoder(style[None])
            return st.decoder(0.4 * ps.adaptive_instance_normalization(f_c, f_s) + 0.6 * f_c)
        followed = torch.clamp(blend(content.permute(0, 3, 1, 2) / 255.0), 0, 1) * 255.0
        reference = blend(content.permute(0, 3, 1, 2))
    assert torch.allclose(got, followed.permute(0, 2, 3, 1), rtol=0, atol=1e-3)
    # the reference's usage leaves the decoder's near-unit range in the 0-255 pipeline: a dark image
    assert got.max() > 100.0 and reference.abs().max() < 10.0


def test_pth_import_equals_jax_importer(tmp_path):
    """pytorch-AdaIN files (all of VGG19's keys in vgg_normalised.pth; the
    10 convs through relu4_1 read) through the port's loader and importer
    equal the JAX importer's trees, carried by style_state_from_jax."""
    enc_path, dec_path = chip_smoke.write_adain_files(str(tmp_path), seed=6)
    sd = load_torch_weights(enc_path)
    assert len(sd) == 2 * len(chip_smoke.ADAIN_VGG19) > 2 * len(ps.ADAIN_VGG_CONVS)
    got_e = ps.import_adain_encoder(sd)
    got_d = ps.import_adain_decoder(load_torch_weights(dec_path))
    want_e, want_d = ps.style_state_from_jax(jax_import.import_adain_encoder(jax_import.load_torch_file(enc_path)),
                                             jax_import.import_adain_decoder(jax_import.load_torch_file(dec_path)))
    for got, want in ((got_e, want_e), (got_d, want_d)):
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    ps.StyleEncoder().load_state_dict(got_e, strict=True)
    ps.StyleDecoder().load_state_dict(got_d, strict=True)


def enhance_cfg(get, tmp_path, *opts):
    cfg = get()
    cfg.merge_from_file(ENHANCE_YAML)
    cfg.merge_from_list(config_opts(LOCKSTEP_OPTS) + list(opts))
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def test_enhance_is_dead_and_missing_files_fall_back(tmp_path, capsys):
    """ENHANCE selects nothing in either package (STYLE.ENABLED does); with
    the YAML's weights/ files absent the port prints the JAX package's
    messages and takes the flat-gray 64x64 style at 0.6 with seeded weights."""
    sources = [os.path.join(dp, f) for dp, _, fs in os.walk(os.path.join(ROOT, "simple_sfod_tpu")) for f in fs
               if f.endswith(".py")]
    reads = [p for p in sources if re.search(r"cfg\.ENHANCE\b", open(p).read()) and not p.endswith("defaults.py")]
    assert not reads
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the YAML's relative weights/ paths resolve to nothing here
    try:
        for enhance, enabled in ((True, True), (False, True), (True, False)):
            tr = build_trainer(enhance_cfg(get_cfg, tmp_path, "ENHANCE", str(enhance), "STYLE.ENABLED", str(enabled)),
                               device="cpu")
            assert (tr.style is not None) == enabled and tr.weak_strong is False
        out = capsys.readouterr().out
    finally:
        os.chdir(cwd)
    assert "[style] STYLE.STYLE_IMAGE missing; using a flat gray style" in out
    assert "[style] VGG_MODEL weights/vgg_normalised.pth missing; random encoder" in out
    assert "[style] DECODER weights/decoder_iter_160000.pth.tar missing; random decoder" in out
    style = build_trainer(enhance_cfg(get_cfg, tmp_path), device="cpu").style
    assert style.style_image.shape == (3, 64, 64) and torch.all(style.style_image == 0.6)


def test_lockstep_one_sfat_style_step_against_jax(tmp_path, monkeypatch):
    """One step of the enhance YAML (the main variant, STYLE.ENABLED, no
    strong view) on the same seeded AdaIN .pth files and baseline-JPEG
    style image in both packages, against the JAX _step_fn_raw. The JAX
    inits run under one jit each (the AdaIN init's values are replaced by
    the files' in both packages)."""
    jit_jax_detector_init(monkeypatch)

    def style_init(rng, style_image, alpha=0.4, use_coral=True):
        dummy = jnp.zeros((1, 64, 64, 3))
        ev = jax.jit(js.StyleEncoder().init)(rng, dummy)
        dv = jax.jit(js.StyleDecoder().init)(rng, jax.eval_shape(js.StyleEncoder().apply, ev, dummy))
        return js.StyleTransfer(ev, dv, style_image, alpha=alpha, use_coral=use_coral)

    monkeypatch.setattr(js.StyleTransfer, "init", staticmethod(style_init))
    enc_path, dec_path = chip_smoke.write_adain_files(str(tmp_path), seed=7)
    opts = ["STYLE.STYLE_IMAGE", chip_smoke.STYLE_JPEG, "STYLE.VGG_MODEL", enc_path, "STYLE.DECODER", dec_path]
    jtr = jax_build_trainer(enhance_cfg(jax_get_cfg, tmp_path, *opts))
    jstyle = jax_closure(jtr._step_fn_raw, "style")
    state = jtr.state
    params = dict(state.params)
    params["det"] = boost(state.params["det"], {1: 4.0}, 1e-2)
    state = dataclasses.replace(state, params=params, teacher_params=boost(state.teacher_params, {1: 4.0}))
    pcfg_node = enhance_cfg(get_cfg, tmp_path, *opts)
    pcfg = detector_config_from_cfg(pcfg_node)
    init = teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, state), pcfg)
    ptr = build_trainer(pcfg_node, device="cpu", weights=init)
    assert ptr.style is not None and not ptr.weak_strong
    np.testing.assert_array_equal(ptr.style.style_image.permute(1, 2, 0).numpy(), np.asarray(jstyle.style_image))

    batch = batches(1)[0]
    images, sizes = jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"])
    new_state, jm = jax.jit(jtr._step_fn_raw)(state, images, sizes, jtr.base_rng)
    counts = anchor_counts(pcfg, CANVAS)
    draws = jax_adapt_draws(jtr.base_rng, 0, BATCH, CANVAS, sum(counts), roi_pool_size(pcfg, counts, 100), False)
    pm = ptr.run_step(batch, draws)
    assert set(pm) == set(jm)
    assert int(pm["num_pseudo"]) == int(jm["num_pseudo"]) > 0
    for k in ("loss_rpn_cls_pseudo", "loss_rpn_loc_pseudo", "loss_cls_pseudo", "loss_box_reg_pseudo", "total_loss"):
        assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (k, float(pm[k]), float(jm[k]))
    for k in ("num_fg_pseudo", "num_sampled_pseudo"):
        assert int(pm[k]) == int(jm[k]), k
    want = teacher_student_from_jax(jax.tree_util.tree_map(np.asarray, new_state), pcfg)
    got = ptr.state.model.state_dict()
    bad = [k for k in want.student if not k.endswith("num_batches_tracked")
           and not (inert_bias_ok(got, init.student, k) if bn_fed_bias(k)
                    else within_tolerance(got[k], want.student[k], init.student[k]))]
    assert not bad, bad
