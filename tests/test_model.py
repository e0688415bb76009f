"""MimoUNet: shape trace, parameter-count parity, golden forward parity."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mimo_unet_tpu.models import (
    MimoUNetConfig,
    count_parameters,
    mimo_unet_apply,
    mimo_unet_init,
)
from mimo_unet_tpu.interop import torch_state_dict_to_pytree

from conftest import requires_reference, import_reference


def small_cfg(**kw):
    base = dict(
        in_channels=3, out_channels=2, num_subnetworks=2, filter_base_count=4
    )
    base.update(kw)
    return MimoUNetConfig(**base)


class TestShapes:
    @pytest.mark.parametrize("s", [1, 2, 3])
    def test_output_shape(self, s):
        cfg = small_cfg(num_subnetworks=s)
        params, state = mimo_unet_init(jax.random.key(0), cfg)
        x = jnp.ones((2, s, 32, 32, 3))
        y, new_state = mimo_unet_apply(params, state, x, cfg, train=False)
        assert y.shape == (2, s, 32, 32, 2)
        assert jax.tree.structure(new_state) == jax.tree.structure(state)

    def test_encoder_params_stacked_on_s(self):
        cfg = small_cfg(num_subnetworks=3)
        params, _ = mimo_unet_init(jax.random.key(0), cfg)
        w = params["encoder"]["in_conv"]["conv1"]["w"]
        assert w.shape == (3, 3, 3, 3, 4)  # [S, kh, kw, in, F]
        # independent per-subnetwork initializations
        assert not np.allclose(np.asarray(w[0]), np.asarray(w[1]))

    def test_internal_shape_trace(self):
        """SURVEY.md §3.2: core widths scale with S, factor=2 for bilinear."""
        cfg = small_cfg(num_subnetworks=2, filter_base_count=4)
        params, _ = mimo_unet_init(jax.random.key(0), cfg)
        fs = 4 * 2
        assert params["core"]["down2"]["conv1"]["w"].shape == (3, 3, 2 * fs, 4 * fs)
        assert params["core"]["down4"]["conv2"]["w"].shape[-1] == 16 * fs // 2
        # decoder up4 consumes core output (2FS/2) + skip (F)
        assert params["decoder"]["up4"]["conv"]["conv1"]["w"].shape == (
            2, 3, 3, fs + 4, (fs + 4) // 2,
        )

    def test_odd_input_sizes(self):
        """Pad-to-match handles non-multiple-of-16 inputs (the reference
        relies on F.pad in Up, components.py:112-115)."""
        cfg = small_cfg()
        params, state = mimo_unet_init(jax.random.key(0), cfg)
        x = jnp.ones((1, 2, 50, 46, 3))
        y, _ = mimo_unet_apply(params, state, x, cfg, train=False)
        assert y.shape == (1, 2, 50, 46, 2)

    def test_dropout_configs_conflict(self):
        with pytest.raises(ValueError):
            small_cfg(encoder_dropout_rate=0.1, center_dropout_rate=0.1)

    def test_rng_required_when_dropout_active(self):
        cfg = small_cfg(center_dropout_rate=0.5)
        params, state = mimo_unet_init(jax.random.key(0), cfg)
        x = jnp.ones((1, 2, 16, 16, 3))
        with pytest.raises(ValueError):
            mimo_unet_apply(params, state, x, cfg, train=True)

    def test_mc_dropout_stochastic_in_eval(self):
        cfg = small_cfg(center_dropout_rate=0.5, final_dropout_rate=0.5)
        params, state = mimo_unet_init(jax.random.key(0), cfg)
        x = jnp.ones((1, 2, 16, 16, 3))
        y1, _ = mimo_unet_apply(
            params, state, x, cfg, train=False, rng=jax.random.key(1), mc_dropout=True
        )
        y2, _ = mimo_unet_apply(
            params, state, x, cfg, train=False, rng=jax.random.key(2), mc_dropout=True
        )
        y_det, _ = mimo_unet_apply(params, state, x, cfg, train=False)
        assert not np.allclose(np.asarray(y1), np.asarray(y2))
        assert not np.allclose(np.asarray(y1), np.asarray(y_det))


class TestNonBilinearCorrected:
    """Model-level transpose/unpool decoders with CORRECTED channel math
    (the reference's own decoder crashes for these configs: ConvTranspose2d
    channel mismatch / MaxUnpool2d indices mismatch, components.py:96-108 +
    model.py:262-294; deviation documented in docs/MIGRATION.md)."""

    @pytest.mark.parametrize(
        "mode_kw",
        [dict(bilinear=False), dict(bilinear=False, use_pooling_indices=True)],
        ids=["transpose", "unpool"],
    )
    def test_forward_shape_and_grads(self, rng, mode_kw):
        cfg = small_cfg(**mode_kw)
        params, state = mimo_unet_init(jax.random.key(0), cfg)
        x = jnp.asarray(
            rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32))

        out, new_state = mimo_unet_apply(params, state, x, cfg, train=False)
        assert out.shape == (2, 2, 32, 32, 2)
        assert bool(jnp.all(jnp.isfinite(out)))

        def loss(p, st):
            y, _ = mimo_unet_apply(p, st, x, cfg, train=True)
            return jnp.mean(jnp.square(y))

        grads = jax.grad(loss)(params, state)
        leaves = jax.tree_util.tree_leaves_with_path(grads)
        assert all(bool(jnp.all(jnp.isfinite(g))) for _, g in leaves)
        # every parameter participates — in particular the decoder's
        # transpose kernel / unpool-fed convs get nonzero gradient.
        # Conv biases are excluded: they cancel analytically under
        # train-mode BatchNorm (docs/MIGRATION.md).
        zero = [jax.tree_util.keystr(k) for k, g in leaves
                if float(jnp.max(jnp.abs(g))) == 0.0
                and not jax.tree_util.keystr(k).endswith("['b']")]
        assert not zero, f"dead parameters: {zero}"

    @pytest.mark.parametrize(
        "mode_kw",
        [dict(bilinear=False), dict(bilinear=False, use_pooling_indices=True)],
        ids=["transpose", "unpool"],
    )
    def test_trains_end_to_end(self, rng, mode_kw):
        import optax

        cfg = small_cfg(**mode_kw)
        params, state = mimo_unet_init(jax.random.key(1), cfg)
        x = jnp.asarray(
            rng.standard_normal((4, 2, 16, 16, 3)).astype(np.float32))
        y_t = jnp.asarray(
            rng.standard_normal((4, 2, 16, 16, 2)).astype(np.float32))
        tx = optax.adam(3e-3)
        opt = tx.init(params)

        @jax.jit
        def step(p, st, opt):
            def loss(p):
                y, new_st = mimo_unet_apply(p, st, x, cfg, train=True)
                return jnp.mean(jnp.square(y - y_t)), new_st

            (val, new_st), g = jax.value_and_grad(loss, has_aux=True)(p)
            upd, opt = tx.update(g, opt)
            return optax.apply_updates(p, upd), new_st, opt, val

        losses = []
        for _ in range(12):
            params, state, opt, val = step(params, state, opt)
            losses.append(float(val))
        assert losses[-1] < losses[0] * 0.9, losses

    @requires_reference
    def test_unpool_s1_full_model_parity(self, rng):
        """At S=1 the reference's unpool decoder is self-consistent (its
        indices/channel mismatch only bites for S > 1), giving a real
        oracle for the full corrected model wiring."""
        cfg = small_cfg(num_subnetworks=1, bilinear=False,
                        use_pooling_indices=True)
        ref = build_reference_model(cfg).eval()
        sd = {k: v.numpy() for k, v in ref.state_dict().items()}
        params, state = torch_state_dict_to_pytree(sd, cfg)

        x = rng.standard_normal((2, 1, 3, 32, 32)).astype(np.float32)
        with torch.no_grad():
            want = ref(torch.tensor(x)).numpy()

        x_nhwc = jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2)))
        got, _ = mimo_unet_apply(params, state, x_nhwc, cfg, train=False)
        got_nchw = np.transpose(np.asarray(got), (0, 1, 4, 2, 3))
        np.testing.assert_allclose(got_nchw, want, atol=2e-4, rtol=1e-4)


@requires_reference
class TestUpBlockParity:
    """Transpose/unpool Up blocks vs the reference, in the core-style
    configuration where the reference itself is consistent (x1 channels ==
    in_channels; its decoder wiring is broken for these modes)."""

    @pytest.mark.parametrize("mode", ["transpose", "unpool"])
    def test_core_style_up(self, rng, mode):
        import_reference()
        from mimo_unet_tpu.models.blocks import up_apply, up_init
        from mimo_unet_tpu.interop import _up as interop_up
        from mimo.models.mimo_components.components import Up as RefUp

        cin, cout = 16, 8
        torch.manual_seed(0)
        ref = RefUp(
            in_channels=cin,
            out_channels=cout,
            bilinear=False,
            use_pooling_indices=(mode == "unpool"),
        ).eval()
        sd = {("x." + k): v.numpy() for k, v in ref.state_dict().items()}
        params, state = interop_up(sd, "x", mode)

        if mode == "transpose":
            # core-style: x1 carries the full in_channels (e.g. up1 on x5)
            x1 = rng.standard_normal((2, cin, 4, 4)).astype(np.float32)
            ind_t, ind_j, pooled_j = None, None, None
        else:
            # unpool-style: x1 carries in_channels//2 with matching indices
            src = rng.standard_normal((2, cin // 2, 8, 8)).astype(np.float32)
            pooled_t, ind_t = torch.nn.functional.max_pool2d(
                torch.tensor(src), 2, return_indices=True
            )
            from mimo_unet_tpu.ops import max_pool_2x2_with_indices

            x1j_src = jnp.asarray(np.moveaxis(src, 1, -1))
            pooled_j, ind_j = max_pool_2x2_with_indices(x1j_src)
            x1 = pooled_t.numpy()
        x2 = rng.standard_normal((2, cin // 2, 8, 8)).astype(np.float32)

        with torch.no_grad():
            want = ref(
                torch.tensor(x1), torch.tensor(x2), pooling_indices=ind_t
            ).numpy()

        x1_j = pooled_j if mode == "unpool" else jnp.asarray(np.moveaxis(x1, 1, -1))
        got, _ = up_apply(
            params, state, x1_j, jnp.asarray(np.moveaxis(x2, 1, -1)), ind_j,
            mode=mode, train=False,
        )
        np.testing.assert_allclose(
            np.moveaxis(np.asarray(got), -1, 1), want, atol=2e-4, rtol=1e-4
        )


def build_reference_model(cfg: MimoUNetConfig):
    import_reference()
    from mimo.models.mimo_components.model import MimoUNet as RefMimoUNet

    torch.manual_seed(0)
    return RefMimoUNet(
        in_channels=cfg.in_channels,
        out_channels=cfg.out_channels,
        num_subnetworks=cfg.num_subnetworks,
        filter_base_count=cfg.filter_base_count,
        bilinear=cfg.bilinear,
        use_pooling_indices=cfg.use_pooling_indices,
    )


@requires_reference
class TestReferenceParity:
    @pytest.mark.parametrize(
        "s,fbc",
        [(1, 4), (2, 4), (3, 5)],
    )
    def test_forward_parity_eval(self, rng, s, fbc):
        cfg = small_cfg(num_subnetworks=s, filter_base_count=fbc)
        ref = build_reference_model(cfg).eval()
        sd = {k: v.numpy() for k, v in ref.state_dict().items()}
        params, state = torch_state_dict_to_pytree(sd, cfg)

        x = rng.standard_normal((2, s, 3, 32, 32)).astype(np.float32)
        with torch.no_grad():
            want = ref(torch.tensor(x)).numpy()  # [B,S,C,H,W]

        x_nhwc = jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2)))
        got, _ = mimo_unet_apply(params, state, x_nhwc, cfg, train=False)
        got_nchw = np.transpose(np.asarray(got), (0, 1, 4, 2, 3))
        np.testing.assert_allclose(got_nchw, want, atol=2e-4, rtol=1e-4)

    def test_forward_parity_train_batchstats(self, rng):
        """Training mode: batch-stat BN + running stat updates must match."""
        cfg = small_cfg(num_subnetworks=2, filter_base_count=4)
        ref = build_reference_model(cfg).train()
        sd = {k: v.numpy() for k, v in ref.state_dict().items()}
        params, state = torch_state_dict_to_pytree(sd, cfg)

        x = rng.standard_normal((4, 2, 3, 32, 32)).astype(np.float32)
        want = ref(torch.tensor(x)).detach().numpy()

        x_nhwc = jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2)))
        got, new_state = mimo_unet_apply(params, state, x_nhwc, cfg, train=True)
        got_nchw = np.transpose(np.asarray(got), (0, 1, 4, 2, 3))
        np.testing.assert_allclose(got_nchw, want, atol=5e-4, rtol=1e-3)

        # running stats updated like torch (check one core BN)
        np.testing.assert_allclose(
            np.asarray(new_state["core"]["down2"]["bn1"]["mean"]),
            ref.core.down2.conv.double_conv[1].running_mean.numpy(),
            atol=1e-5,
        )
        # and one vmapped per-subnetwork BN
        np.testing.assert_allclose(
            np.asarray(new_state["encoder"]["in_conv"]["bn1"]["mean"][1]),
            ref.encoder.in_convs[1].double_conv[1].running_mean.numpy(),
            atol=1e-5,
        )

    def test_gradient_parity_vs_torch(self, rng):
        """End-to-end parameter gradients match torch autograd through the
        full model (train mode, Laplace NLL) with transplanted weights."""
        import torch.nn.functional  # noqa: F401

        cfg = small_cfg(num_subnetworks=2, filter_base_count=4)
        ref = build_reference_model(cfg).train()
        sd = {k: v.numpy() for k, v in ref.state_dict().items()}
        params, state = torch_state_dict_to_pytree(sd, cfg)

        x = rng.standard_normal((2, 2, 3, 32, 32)).astype(np.float32)
        y = rng.standard_normal((2, 2, 1, 32, 32)).astype(np.float32)

        # torch side
        out_t = ref(torch.tensor(x))
        p1_t, p2_t = out_t[:, :, :1], out_t[:, :, 1:]
        scale = torch.exp(p2_t)
        loss_t = (torch.log(scale) + (p1_t - torch.tensor(y)).abs() / scale).mean()
        loss_t.backward()

        # jax side
        from mimo_unet_tpu.losses import LaplaceNLL

        loss_fn = LaplaceNLL()
        x_j = jnp.asarray(np.transpose(x, (0, 1, 3, 4, 2)))
        y_j = jnp.asarray(np.transpose(y, (0, 1, 3, 4, 2)))

        def loss(params):
            out, _ = mimo_unet_apply(params, state, x_j, cfg, train=True)
            return loss_fn(out[..., :1], out[..., 1:], y_j)

        val, grads = jax.value_and_grad(loss)(params)
        np.testing.assert_allclose(float(val), float(loss_t), rtol=1e-4)

        def torch_grad(name):
            return dict(ref.named_parameters())[name].grad.numpy()

        # spot-check gradients across encoder / core / decoder
        np.testing.assert_allclose(
            np.asarray(grads["core"]["down2"]["conv1"]["w"]),
            np.transpose(torch_grad("core.down2.conv.double_conv.0.weight"),
                         (2, 3, 1, 0)),
            atol=1e-4, rtol=1e-3,
        )
        np.testing.assert_allclose(
            np.asarray(grads["encoder"]["in_conv"]["conv1"]["w"][1]),
            np.transpose(torch_grad("encoder.in_convs.1.double_conv.0.weight"),
                         (2, 3, 1, 0)),
            atol=1e-4, rtol=1e-3,
        )
        np.testing.assert_allclose(
            np.asarray(grads["decoder"]["up4"]["conv"]["conv2"]["w"][0]),
            np.transpose(torch_grad("decoder.up4s.0.conv.double_conv.3.weight"),
                         (2, 3, 1, 0)),
            atol=1e-4, rtol=1e-3,
        )
        np.testing.assert_allclose(
            np.asarray(grads["core"]["up1"]["conv"]["bn1"]["scale"]),
            torch_grad("core.up1.conv.double_conv.1.weight"),
            atol=1e-4, rtol=1e-3,
        )

    @pytest.mark.parametrize("s,fbc", [(1, 21), (2, 21), (2, 30), (4, 16)])
    def test_param_count_parity(self, s, fbc):
        import_reference()

        cfg = MimoUNetConfig(
            in_channels=3, out_channels=2, num_subnetworks=s, filter_base_count=fbc
        )
        ref = build_reference_model(cfg)
        want = sum(p.numel() for p in ref.parameters() if p.requires_grad)
        # count_parameters includes BN scale/bias (trainable in torch too)
        params, _ = mimo_unet_init(jax.random.key(0), cfg)
        assert count_parameters(params) == want
