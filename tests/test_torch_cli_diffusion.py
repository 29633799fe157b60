"""The port's CLI and the JAX package's on one DiffusionFast checkpoint
written by the JAX package (the helpers of tests/test_torch_cli.py): with
random vocoders that the two sides do not share, the outputs have the same
length and rate, and the port's is finite and not silent."""
import jax
import jax.numpy as jnp
import numpy as np
from scipy.io import wavfile

import ddsp_svc_tpu.cli.infer as jcli
import ddsp_svc_tpu_torch.cli.infer as pcli
from ddsp_svc_tpu.train.checkpoint import save_checkpoint
from ddsp_svc_tpu.utils.config import save_config
from test_torch_cli import N_UNIT, _data, _encoder_npz, _write_wav


def test_diffusion_cli_matches_jax_length(tmp_path, monkeypatch):
    """Both random NSF-HiFiGANs at 32 channels (the rates and hops of the
    default one)."""
    import ddsp_svc_tpu.models.vocoder as jvoc
    import ddsp_svc_tpu_torch.models.vocoder as pvoc
    from ddsp_svc_tpu.models.cascade import Unit2WavFast
    from ddsp_svc_tpu.ops.mel import LogMelSpectrogram

    for module in (jvoc, pvoc):
        monkeypatch.setattr(module, "DEFAULT_NSF_CONFIG", dict(
            module.DEFAULT_NSF_CONFIG, upsample_initial_channel=32))

    sr, hop, t = 44100, 512, 8
    model = Unit2WavFast(sr, hop, 2048, n_unit=N_UNIT, n_spk=2, out_dims=128,
                         n_layers=2, n_chans=16, k_step_max=20)
    params = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, N_UNIT)), jnp.full((1, t, 1), 220.0),
        jnp.ones((1, t, 1)), spk_id=jnp.ones((1, 1), jnp.int32),
        mel_extract_fn=LogMelSpectrogram().extract,
        gt_spec=jnp.zeros((1, t, 128)), infer=False,
        key=jax.random.PRNGKey(2)))()["params"])
    save_checkpoint(str(tmp_path), 9, params)
    save_config(tmp_path / "config.yaml", {
        "data": _data(sr, hop, _encoder_npz(tmp_path / "encoder.npz")),
        "model": {"type": "DiffusionFast", "win_length": 2048, "n_spk": 2,
                  "n_layers": 2, "n_chans": 16, "k_step_max": 20},
        "vocoder": {"type": "nsf-hifigan", "ckpt": None},
        "infer": {"method": "dpm-solver"}})
    in_wav = tmp_path / "in.wav"
    _write_wav(in_wav, 22050, 0.4)
    outs = {}
    for name, main in (("jax", jcli.main), ("port", pcli.main)):
        argv = ["-m", str(tmp_path / "model_9.ckpt"), "-i", str(in_wav),
                "-o", str(tmp_path / f"{name}.wav"), "-id", "1", "-diffid", "2",
                "-kstep", "20", "-speedup", "10"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        outs[name] = wavfile.read(tmp_path / f"{name}.wav")
    assert outs["port"][0] == outs["jax"][0] == sr
    assert outs["port"][1].shape == outs["jax"][1].shape
    assert np.isfinite(outs["port"][1].astype(np.float32)).all()
    assert np.abs(outs["port"][1]).max() > 0
