"""MSR-Action3D clips and their batches (``tpugan_tpu/data/msr.py``).

Video files ``a{label}_s{subject}_e{ex}_sdepth.npz`` hold an object array
``point_clouds`` of per-frame [Ni, 3] clouds in depth-camera units;
subjects <= 5 are the train split, > 5 the test split. A clip of
``frames_per_clip`` frames: every frame resampled (random subset, or whole
repeats plus a random residue) to ``num_points`` with y flipped; in the
train split scaled by a random 0.9-1.1 per axis, divided by 300 and
centred on the middle frame's mean; in the test split divided by 300 and
centred per frame (the centres are returned). ``lowres_pos`` is each
frame's host FPS downsample to ``fps_ratio`` of its points.

The same seed draws the same clips as the JAX package: every random call
goes to the same numpy generator in the same order.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpugan_tpu_torch.data.sampling import farthest_point_sampling


class MSRAction3DDataset:
    def __init__(self, root: str, frames_per_clip: int = 3,
                 num_points: int = 2048, step_between_clips: int = 1,
                 train: bool = True, fps_ratio: float = 0.0625,
                 return_lowres: bool = True, seed: int = 0):
        self.num_points = num_points
        self.frames_per_clip = frames_per_clip
        self.step_between_clips = step_between_clips
        self.train = train
        self.fps_ratio = fps_ratio
        self.return_lowres = return_lowres
        self.rng = np.random.default_rng(seed)

        self.videos: List[np.ndarray] = []
        self.labels: List[int] = []
        self.index_map: List[Tuple[int, int]] = []
        span = step_between_clips * (frames_per_clip - 1)
        for video_name in sorted(os.listdir(root)):
            subject = int(video_name.split("_")[1].split("s")[1])
            if train != (subject <= 5):
                continue
            video = np.load(os.path.join(root, video_name),
                            allow_pickle=True)["point_clouds"]
            index = len(self.videos)
            self.videos.append(video)
            self.labels.append(int(video_name.split("_")[0][1:]) - 1)
            for t in range(0, video.shape[0] - span, step_between_clips):
                self.index_map.append((index, t))
        self.num_classes = max(self.labels) + 1 if self.labels else 0

    def __len__(self) -> int:
        return len(self.index_map)

    def _resample_frame(self, p: np.ndarray, rng) -> np.ndarray:
        """Random subset, or whole repeats plus a random residue, of
        ``num_points`` rows; y flipped."""
        n = p.shape[0]
        if n > self.num_points:
            r = rng.choice(n, self.num_points, replace=False)
        else:
            repeat, residue = self.num_points // n, self.num_points % n
            r = np.concatenate([np.arange(n)] * repeat
                               + [rng.choice(n, residue, replace=False)])
        p = p.copy()
        p[:, 1] = -p[:, 1]
        return p[r, :]

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
        """One clip: ``highres_pos`` [F, P, 3] f32 and ``label``; with
        ``return_lowres`` also ``lowres_pos`` [F, P * fps_ratio, 3]; in the
        test split also ``centers`` [F, 3] and ``video_index``. ``rng``
        (default: the dataset's own) lets threads draw independently."""
        rng = rng or self.rng
        index, t = self.index_map[idx]
        video = self.videos[index]
        clip = np.stack([
            self._resample_frame(np.asarray(
                video[t + i * self.step_between_clips], np.float64), rng)
            for i in range(self.frames_per_clip)])               # [F, P, 3]
        centers = None
        if self.train:
            clip = clip * rng.uniform(0.9, 1.1, 3)
            clip /= 300.0
            clip -= np.mean(clip[len(clip) // 2], axis=0)
        else:
            clip /= 300.0
            centers = np.mean(clip, axis=1, keepdims=True)       # [F, 1, 3]
            clip = clip - centers
            centers = centers[:, 0, :]
        highres = clip.astype(np.float32)
        out = {"highres_pos": highres, "label": np.int32(self.labels[index])}
        if self.return_lowres:
            k = int(self.num_points * self.fps_ratio)
            out["lowres_pos"] = np.stack([
                highres[f][farthest_point_sampling(highres[f], k, rng=rng)[0]]
                for f in range(self.frames_per_clip)])
        if centers is not None:
            out["centers"] = centers.astype(np.float32)
            out["video_index"] = np.int32(index)
        return out


def action_batch_iterator(dataset: MSRAction3DDataset, batch_size: int,
                          seed: int = 0, shuffle: bool = True,
                          endless: bool = True
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of whole clips, frame-major: ``highres_pos`` [F, B, P, 3]
    (and ``lowres_pos``), ``label`` [B] (and ``video_index``). An epoch is
    a permutation of the clips (their order with ``shuffle`` off) cut into
    full batches; each clip draws from its own generator, spawned from
    ``seed + 1``, so threads assemble a batch in any order."""
    rng = np.random.default_rng(seed)
    seed_seq = np.random.SeedSequence(seed + 1)
    n = len(dataset)
    with ThreadPoolExecutor(max_workers=min(8, max(2, batch_size))) as pool:
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n - batch_size + 1, batch_size):
                child_seeds = seed_seq.spawn(batch_size)
                items = list(pool.map(
                    lambda args: dataset.__getitem__(
                        int(args[0]), rng=np.random.default_rng(args[1])),
                    zip(order[start:start + batch_size], child_seeds)))
                batch = {"highres_pos": np.stack(
                             [x["highres_pos"] for x in items], axis=1),
                         "label": np.stack([x["label"] for x in items])}
                if "lowres_pos" in items[0]:
                    batch["lowres_pos"] = np.stack(
                        [x["lowres_pos"] for x in items], axis=1)
                if "video_index" in items[0]:
                    batch["video_index"] = np.stack(
                        [x["video_index"] for x in items])
                yield batch
            if not endless:
                return
