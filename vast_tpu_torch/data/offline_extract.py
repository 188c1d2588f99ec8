"""Offline frame and audio extraction with ffmpeg (host-side tooling).

The port's own copy of ``vast_tpu.data.offline_extract``: the
reference's utils/offline_process_data.py:22-86 runs ffmpeg per video
(frames at a fixed fps as JPEGs, and a mono wav at a target sample rate)
over a multiprocessing pool; here as a CLI, without ``shell=True``. The
port's loaders read what it writes (``vision_format: video_frame``
directories, wav files).

ffmpeg is not bundled; the tool fails fast with a clear message when the
binary is missing. Usage:

    python -m vast_tpu_torch.data.offline_extract INPUT_DIR OUTPUT_DIR \
        --fps 1 --sr 22050 --workers 20 [--no-frames] [--no-audio]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import subprocess
import sys

VIDEO_EXTS = (".mp4", ".mkv", ".avi", ".webm", ".mov", ".gif")


def frame_cmd(video_path: str, frame_dir: str, fps: float,
              ffmpeg: str = "ffmpeg") -> list[str]:
    """Frames at ``fps`` as frame_%04d.jpg (reference cmd at
    offline_process_data.py:31-32: image2, -vsync 0, -qscale:v 2)."""
    return [ffmpeg, "-loglevel", "error", "-i", video_path,
            "-vsync", "0", "-f", "image2", "-vf", f"fps=fps={fps:.02f}",
            "-qscale:v", "2", os.path.join(frame_dir, "frame_%04d.jpg")]


def audio_cmd(video_path: str, wav_path: str, sr: int,
              ffmpeg: str = "ffmpeg") -> list[str]:
    """Mono wav at ``sr`` Hz (reference cmd at
    offline_process_data.py:48-49: -f wav -vn -ac 1 -ab 16k)."""
    return [ffmpeg, "-i", video_path, "-loglevel", "error", "-f", "wav",
            "-vn", "-ac", "1", "-ab", "16k", "-ar", str(sr), "-y", wav_path]


def extract_one(video_path: str, output_dir: str, *, fps: float = 1.0,
                sr: int = 22050, frames: bool = True, audio: bool = True,
                ffmpeg: str = "ffmpeg") -> bool:
    """Extract one video; returns True on success, warns-and-continues on
    failure (the reference swallows per-video errors the same way)."""
    name = os.path.splitext(os.path.basename(video_path))[0]
    try:
        if frames:
            frame_dir = os.path.join(output_dir, f"frames_fps{fps:g}", name)
            os.makedirs(frame_dir, exist_ok=True)
            subprocess.run(frame_cmd(video_path, frame_dir, fps, ffmpeg),
                           check=True)
        if audio:
            wav_dir = os.path.join(output_dir, "audios")
            os.makedirs(wav_dir, exist_ok=True)
            subprocess.run(
                audio_cmd(video_path, os.path.join(wav_dir, name + ".wav"),
                          sr, ffmpeg),
                check=True)
        return True
    except (subprocess.CalledProcessError, OSError) as e:
        print(f"warn: {video_path}: {e}", file=sys.stderr)
        return False


def _worker(args):
    video_path, output_dir, kw = args
    return extract_one(video_path, output_dir, **kw)


def extract_all(input_dir: str, output_dir: str, *, workers: int = 20,
                **kw) -> tuple[int, int]:
    """Extract every video under input_dir; returns (ok, failed)."""
    vids = sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if f.lower().endswith(VIDEO_EXTS))
    jobs = [(v, output_dir, kw) for v in vids]
    if workers <= 1:
        results = [_worker(j) for j in jobs]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            results = pool.map(_worker, jobs)
    ok = sum(results)
    return ok, len(results) - ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--fps", type=float, default=1.0)
    ap.add_argument("--sr", type=int, default=22050)
    ap.add_argument("--workers", type=int, default=20)
    ap.add_argument("--ffmpeg", default="ffmpeg")
    ap.add_argument("--no-frames", dest="frames", action="store_false")
    ap.add_argument("--no-audio", dest="audio", action="store_false")
    args = ap.parse_args(argv)
    if shutil.which(args.ffmpeg) is None:
        ap.error(f"ffmpeg binary not found: {args.ffmpeg!r} — install "
                 "ffmpeg or pass --ffmpeg /path/to/ffmpeg")
    ok, failed = extract_all(
        args.input_dir, args.output_dir, workers=args.workers,
        fps=args.fps, sr=args.sr, frames=args.frames, audio=args.audio,
        ffmpeg=args.ffmpeg)
    print(f"extracted {ok} videos, {failed} failed")
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
