"""Training dataset over the preprocessed .npy layout (the port's copy of
ddsp_svc_tpu/data/dataset.py: ``AudioDataset``, ``BatchSampler``,
``get_datasets``). Pure numpy with the same RNG stream, so a batch is bit
for bit the JAX package's batch for the same corpus and seed:

  - per-file buffers preloaded host-side (f0/volume/spk_id, and
    audio/units [+mel/aug_mel] when cache_all_data);
  - random crops of ``waveform_sec`` aligned to the hop grid; files shorter
    than the crop are skipped at index time;
  - random gain augmentation 10^U(-1, min(1, log10(1/max_amp))) applied to
    audio and volume;
  - diffusion/reflow extras: mel/aug_mel pairs, 50 % aug_flag picking the
    augmented pair and scaling f0 by 2^(keyshift/12) on the host (f0 stays
    data: it never requires grad), aug_shift returned;
  - multi-host sharding: each host keeps files[rank::world].

``data/prefetch.PrefetchBatchSampler``, the C++ prefetcher, is bit-matched
to ``BatchSampler``; the solver takes it for an uncached corpus without
mels, as the JAX solver does.

spk_id parsing: first integer chunk of the file's directory name, 1-based.
"""
from __future__ import annotations

import os
import re

import numpy as np

from ..features.audio import load_wav
from ..utils.config import traverse_dir


def _spk_id_from_name(name_ext: str, n_spk) -> int:
    if n_spk is None or n_spk <= 1:
        return 1
    dirname_split = re.split(r"_|\-", os.path.dirname(name_ext), 2)[0]
    spk_id = int(dirname_split) if dirname_split.isdigit() else 0
    if spk_id < 1 or spk_id > n_spk:
        raise ValueError(
            " [x] Muiti-speaker traing error : spk_id must be a positive "
            "integer from 1 to n_spk "
        )
    return spk_id


class AudioDataset:
    def __init__(
        self,
        path_root: str,
        waveform_sec: float,
        hop_size: int,
        sample_rate: int,
        load_all_data: bool = True,
        whole_audio: bool = False,
        extensions: tuple[str, ...] = ("wav",),
        n_spk: int = 1,
        use_aug: bool = False,
        with_mel: bool = False,
        load_audio: bool = True,
        rank: int = 0,
        world_size: int = 1,
    ):
        self.path_root = path_root
        self.waveform_sec = waveform_sec
        self.hop_size = hop_size
        self.sample_rate = sample_rate
        self.whole_audio = whole_audio
        self.use_aug = use_aug
        self.with_mel = with_mel
        self.load_audio = load_audio

        paths = traverse_dir(
            os.path.join(path_root, "audio"),
            extensions=list(extensions),
            is_pure=True,
            is_sort=True,
        )
        self.paths = paths[rank::world_size]
        if with_mel:
            aug_dict_path = os.path.join(path_root, "pitch_aug_dict.npy")
            self.pitch_aug_dict = (
                np.load(aug_dict_path, allow_pickle=True).item()
                if os.path.exists(aug_dict_path)
                else {}
            )

        self.buffer: dict[str, dict] = {}
        for name_ext in self.paths:
            entry = {
                "f0": np.load(self._feat(name_ext, "f0")).astype(np.float32)[:, None],
                "volume": np.load(self._feat(name_ext, "volume")).astype(np.float32)[
                    :, None
                ],
                "spk_id": np.array([_spk_id_from_name(name_ext, n_spk)], np.int64),
            }
            entry["n_frames"] = len(entry["f0"])
            entry["duration"] = entry["n_frames"] * hop_size / sample_rate
            if load_all_data:
                if self.load_audio:
                    audio, sr = load_wav(os.path.join(path_root, "audio", name_ext))
                    assert sr == sample_rate, f"{name_ext}: {sr} != {sample_rate}"
                    entry["audio"] = audio.astype(np.float32)
                entry["units"] = np.load(self._feat(name_ext, "units")).astype(
                    np.float32
                )
                if with_mel:
                    entry["mel"] = np.load(self._feat(name_ext, "mel")).astype(
                        np.float32
                    )
                    entry["aug_mel"] = np.load(self._feat(name_ext, "aug_mel")).astype(
                        np.float32
                    )
                    entry["aug_vol"] = np.load(self._feat(name_ext, "aug_vol")).astype(
                        np.float32
                    )[:, None]
                    entry["keyshift"] = float(self.pitch_aug_dict.get(name_ext, 0.0))
            self.buffer[name_ext] = entry

        self.crop_frames = int(
            waveform_sec / (hop_size / sample_rate)
        )  # units_frame_len

    def _feat(self, name_ext: str, kind: str) -> str:
        return os.path.join(self.path_root, kind, name_ext) + ".npy"

    def __len__(self):
        return len(self.paths)

    def usable(self) -> list[str]:
        """Files long enough for a crop (reference skips short ones)."""
        return [
            p
            for p in self.paths
            if self.buffer[p]["duration"] >= self.waveform_sec + 0.1
        ]

    def sample_crop(self, name_ext: str, rng: np.random.Generator) -> dict:
        """One training example: random hop-aligned crop + augmentations."""
        entry = self.buffer[name_ext]
        tf = self.crop_frames
        if self.whole_audio:
            start_frame, tf = 0, entry["n_frames"] - 1
        else:
            frame_res = self.hop_size / self.sample_rate
            idx_from = rng.uniform(0, entry["duration"] - self.waveform_sec - 0.1)
            start_frame = int(idx_from / frame_res)

        sl = slice(start_frame, start_frame + tf)
        out = {
            "f0": entry["f0"][sl],
            "volume": entry["volume"][sl],
            "spk_id": entry["spk_id"],
        }
        units = entry.get("units")
        if units is None:
            units = np.load(self._feat(name_ext, "units")).astype(np.float32)
        out["units"] = units[sl]

        if self.load_audio:
            audio = entry.get("audio")
            if audio is None:
                audio, sr = load_wav(os.path.join(self.path_root, "audio", name_ext))
                # the cached path asserts this at load time; the lazy path
                # must too — a mismatched-rate wav would otherwise train on
                # silently time-shifted, wrongly-scaled crops
                assert sr == self.sample_rate, (
                    f"{name_ext}: wav rate {sr} != config {self.sample_rate}"
                )
                audio = audio.astype(np.float32)
            out["audio"] = audio[start_frame * self.hop_size : (start_frame + tf) * self.hop_size]
            if len(out["audio"]) < tf * self.hop_size:
                out["audio"] = np.pad(
                    out["audio"], (0, tf * self.hop_size - len(out["audio"]))
                )

        if self.with_mel:
            aug_flag = self.use_aug and rng.random() > 0.5
            keyshift = entry.get("keyshift")
            if keyshift is None:  # uncached corpus: not preloaded
                keyshift = float(self.pitch_aug_dict.get(name_ext, 0.0))
            if aug_flag:
                mel = entry.get("aug_mel")
                if mel is None:
                    mel = np.load(self._feat(name_ext, "aug_mel")).astype(
                        np.float32
                    )
                aug_vol = entry.get("aug_vol")
                if aug_vol is None:
                    aug_vol = np.load(self._feat(name_ext, "aug_vol")).astype(
                        np.float32
                    )[:, None]
                out["volume"] = aug_vol[sl]
                out["f0"] = out["f0"] * 2 ** (keyshift / 12.0)
                out["aug_shift"] = np.array([[keyshift]], np.float32)
            else:
                mel = entry.get("mel")
                if mel is None:
                    mel = np.load(self._feat(name_ext, "mel")).astype(
                        np.float32
                    )
                out["aug_shift"] = np.array([[0.0]], np.float32)
            out["mel"] = mel[sl]
        elif self.use_aug and self.load_audio:
            max_amp = float(np.max(np.abs(out["audio"]))) + 1e-5
            max_shift = min(1.0, np.log10(1.0 / max_amp))
            gain = 10.0 ** rng.uniform(-1.0, max_shift)
            out["audio"] = out["audio"] * gain
            out["volume"] = out["volume"] * gain
        return out


class BatchSampler:
    """Stateless-ish batch assembler: fixed shapes, numpy stack, ready for
    one device_put per step (the DataLoader(num_workers) replacement)."""

    def __init__(self, dataset: AudioDataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.files = dataset.usable()
        if not self.files:
            raise ValueError(f"no usable files in {dataset.path_root}")

    def sample(self) -> dict[str, np.ndarray]:
        names = self.rng.choice(len(self.files), self.batch_size)
        items = [self.dataset.sample_crop(self.files[i], self.rng) for i in names]
        return {
            k: np.stack([it[k] for it in items], axis=0) for k in items[0].keys()
        }

    def __iter__(self):
        while True:
            yield self.sample()


def get_datasets(args, whole_audio_valid: bool = True, rank: int = 0, world_size: int = 1):
    """Build train/valid datasets from a reference-schema config
    (data_loaders.py:52-89 contract)."""
    with_mel = args.model.type in ("Diffusion", "DiffusionNew", "DiffusionFast",
                                   "RectifiedFlow")
    common = dict(
        waveform_sec=args.data.duration,
        hop_size=args.data.block_size,
        sample_rate=args.data.sampling_rate,
        n_spk=args.model.n_spk,
        with_mel=with_mel,
    )
    train = AudioDataset(
        args.data.train_path,
        load_all_data=bool(args.train.cache_all_data),
        whole_audio=False,
        use_aug=True,
        rank=rank,
        world_size=world_size,
        **common,
    )
    valid = AudioDataset(
        args.data.valid_path,
        load_all_data=True,
        whole_audio=whole_audio_valid,
        use_aug=False,
        **common,
    )
    return train, valid
