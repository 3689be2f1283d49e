"""Video/frames -> DVS events on the card (v2e/v2e.py's command).

Port of ``tools/v2e.py``: read frames -> luma -> (optional SuperSloMo
upsampling, a fixed or a flow-adaptive factor) -> the emulator in chunks of
frames -> outputs: the events as CSV (``--dvs_text``), AEDAT2
(``--dvs_aedat2``), HDF5 (``--dvs_h5``) and numpy (``--dvs_numpy``),
rendered event frames and ``dvs-video.avi``, and previews of the input and
the upsampled video (``--vid_orig`` / ``--vid_slomo``). The flags are the
JAX tool's, with ``--device`` (cuda unless given ``cpu``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.v2e -i FRAMES_DIR -o OUT \\
        [--slomo_upsample 4 --slomo_model SuperSloMo39.ckpt] [--dvs_params noisy] [--device cpu]

Frames stay on the device from the upsampling to the rendered frames;
the emulator's dense maps become sparse events on the device, chunk by
chunk, and only the events come to the host. SloMo runs ``--batch_size``
source pairs at a time (the JAX tool runs one). ``--slomo_model`` takes
the official checkpoint's layout (``state_dictFC`` / ``state_dictAT``);
without it the weights are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import math
import os
import sys
import time
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..events import io as ev_io
from ..events import renderer as R
from ..events.emulator import EmulatorConfig, emulate_sequence, init_state
from ..events.synthetic_input import SyntheticInput


def load_frames(input_path: str, height: int | None, width: int | None) -> np.ndarray:
    """A video file or a folder of images -> (N, H, W) float32 luma."""
    import cv2

    if os.path.isdir(input_path):
        files = sorted(f for f in os.listdir(input_path) if f.lower().endswith((".png", ".jpg", ".bmp")))
        frames = []
        for f in files:
            img = cv2.imread(os.path.join(input_path, f), cv2.IMREAD_GRAYSCALE)
            if height and width:
                img = cv2.resize(img, (width, height))
            frames.append(img)
        return np.stack(frames).astype(np.float32)
    cap = cv2.VideoCapture(input_path)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        if height and width:
            img = cv2.resize(img, (width, height))
        frames.append(img)
    cap.release()
    return np.stack(frames).astype(np.float32)


def set_output_dimension(args):
    """Camera-preset geometry (v2e_utils.set_output_dimension:166-189)."""
    w, h = args.output_width, args.output_height
    if args.dvs128:
        w, h = 128, 128
    elif args.dvs240:
        w, h = 240, 180
    elif args.dvs346:
        w, h = 346, 260
    elif args.dvs640:
        w, h = 640, 480
    elif args.dvs1024:
        w, h = 1024, 768
    if w is None or h is None:
        w = h = None  # auto from source
    return w, h


def check_lowpass(cutoff_hz: float, fs: float) -> bool:
    """Warn when the IIR photoreceptor low-pass is under-sampled
    (v2e_utils.py:192-224: eps = dt/tau must stay <= 0.3). True if OK."""
    if cutoff_hz <= 0 or fs <= 0:
        return True
    maxeps = 0.3
    tau = 1.0 / (2 * math.pi * cutoff_hz)
    eps = (1.0 / fs) / tau
    if eps > maxeps:
        print(
            f"WARNING: lowpass cutoff {cutoff_hz:g} Hz (tau={tau:.3g}s) is "
            f"under-sampled at fs={fs:g} Hz: IIR mixing factor "
            f"eps=dt/tau={eps:.3f} > {maxeps}; decrease "
            f"--timestamp_resolution below {tau * maxeps:.3g}s or "
            f"--cutoff_hz below {maxeps * fs / (2 * math.pi):.3g} Hz",
            file=sys.stderr,
        )
        return False
    return True


def resolve_output_folder(args) -> str:
    """--output_in_place / --overwrite / --unique_output_folder semantics."""
    if args.output_in_place:
        if not args.input:
            raise SystemExit("--output_in_place requires --input (a file/folder); "
                             "use --output_folder with --synthetic_input")
        return args.input if os.path.isdir(args.input) else os.path.dirname(args.input)
    folder = args.output_folder
    if os.path.isdir(folder) and os.listdir(folder) and not args.overwrite:
        if args.unique_output_folder:
            k = 1
            while os.path.isdir(f"{folder}-{k}") and os.listdir(f"{folder}-{k}"):
                k += 1
            folder = f"{folder}-{k}"
        else:
            raise SystemExit(f"output folder {folder} is not empty; use --overwrite or --unique_output_folder")
    return folder


def write_avi(frames_u8, path, fps):
    """Grey frame stack -> avi (renderer.py:327-343 video output)."""
    import cv2

    frames_u8 = np.asarray(frames_u8)
    if frames_u8.ndim == 3:
        frames_u8 = frames_u8[..., None].repeat(3, axis=-1)
    h, w = frames_u8.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), max(fps, 1.0), (w, h))
    for fr in frames_u8:
        vw.write(fr.astype(np.uint8))
    vw.release()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="DVS event-camera simulation (v2e equivalent)")
    inp = ap.add_argument_group("Input file handling")
    inp.add_argument("-i", "--input", default=None, help="video file or frames dir")
    inp.add_argument("--input_frame_rate", type=float, default=30.0)
    inp.add_argument("--input_slowmotion_factor", type=float, default=1.0,
                     help="source video is already slowed by this factor")
    inp.add_argument("--start_time", type=float, default=None)
    inp.add_argument("--stop_time", type=float, default=None)
    inp.add_argument("--crop", type=int, nargs=4, default=None, metavar=("LEFT", "RIGHT", "TOP", "BOTTOM"))

    syn = ap.add_argument_group("Synthetic input")
    syn.add_argument("--synthetic_input", default=None,
                     help="python module exposing a SyntheticInput subclass ('pkg.module' or 'pkg.module:Class')")

    outg = ap.add_argument_group("Output: General")
    outg.add_argument("-o", "--output-folder", "--output_folder", dest="output_folder", default="v2e-output")
    outg.add_argument("--overwrite", action="store_true")
    outg.add_argument("--unique_output_folder", action=argparse.BooleanOptionalAction, default=True)
    outg.add_argument("--output_in_place", action="store_true")
    outg.add_argument("--avi_frame_rate", type=float, default=30.0)

    tsg = ap.add_argument_group("DVS timestamp resolution")
    tsg.add_argument("--auto_timestamp_resolution", action="store_true",
                     help="choose the SloMo upsampling so optical flow <= 1 px per interpolated frame")
    tsg.add_argument("--timestamp_resolution", type=float, default=None,
                     help="desired DVS timestamp resolution in seconds")

    mdl = ap.add_argument_group("DVS model")
    mdl.add_argument("--output_height", type=int, default=None)
    mdl.add_argument("--output_width", type=int, default=None)
    mdl.add_argument("--dvs_params", choices=["clean", "noisy"], default="clean")
    mdl.add_argument("--pos_thres", type=float, default=None)
    mdl.add_argument("--neg_thres", type=float, default=None)
    mdl.add_argument("--sigma_thres", type=float, default=None)
    mdl.add_argument("--cutoff_hz", type=float, default=None)
    mdl.add_argument("--leak_rate_hz", type=float, default=None)
    mdl.add_argument("--shot_noise_rate_hz", type=float, default=None)
    mdl.add_argument("--leak_jitter_fraction", type=float, default=None)
    mdl.add_argument("--noise_rate_cov_decades", type=float, default=None)
    mdl.add_argument("--refractory_period", type=float, default=None)
    mdl.add_argument("--dvs_emulator_seed", type=int, default=None)
    mdl.add_argument("--dvs_max_iters", type=int, default=None,
                     help="static per-frame event-iteration cap (EmulatorConfig.max_iters); raise it when the "
                          "overflow warning reports clipped events (memory scales linearly with it)")
    mdl.add_argument("--dvs_frame_chunk", type=int, default=64,
                     help="frames per emulator chunk; bounds device memory at chunk*max_iters*H*W*2 bytes of "
                          "dense event maps (the emulator state carries across chunks, so the event stream "
                          "equals one run over the whole stream)")
    mdl.add_argument("--show_dvs_model_state", nargs="*", default=None,
                     help="(GUI-only; accepted and ignored headless)")
    cam = ap.add_argument_group("DVS camera sizes")
    cam.add_argument("--dvs128", action="store_true")
    cam.add_argument("--dvs240", action="store_true")
    cam.add_argument("--dvs346", action="store_true")
    cam.add_argument("--dvs640", action="store_true")
    cam.add_argument("--dvs1024", action="store_true")

    slo = ap.add_argument_group("SloMo upsampling")
    slo.add_argument("--disable_slomo", action="store_true")
    slo.add_argument("--slomo_model", default=None, help="SuperSloMo39 torch .ckpt to load")
    slo.add_argument("--slomo_upsample", type=int, default=1, help="fixed SuperSloMo interpolation factor (1 = off)")
    slo.add_argument("--batch_size", type=int, default=4, help="source frame pairs a SloMo call")
    slo.add_argument("--vid_orig", default=None, help="write the (possibly resized) input as avi")
    slo.add_argument("--vid_slomo", default=None, help="write the slomo-upsampled video as avi")

    vid = ap.add_argument_group("Output: DVS video")
    vid.add_argument("--dvs_exposure", nargs="+", default=["duration", "0.01"],
                     help="duration SECONDS | count N | area_count N DIM")
    vid.add_argument("--dvs_vid", default="dvs-video.avi")
    vid.add_argument("--dvs_vid_full_scale", type=int, default=2)
    vid.add_argument("--skip_video_output", action="store_true")
    vid.add_argument("--no_preview", action="store_true", help="(GUI-only; accepted and ignored headless)")
    vid.add_argument("--frame_rate", type=float, default=None,
                     help="fixed event-frame rate (overrides exposure duration)")
    vid.add_argument("--no_frames", action="store_true")

    evo = ap.add_argument_group("Output: DVS events")
    evo.add_argument("--dvs_text", default=None)
    evo.add_argument("--dvs_aedat2", default=None)
    evo.add_argument("--dvs_h5", default=None)
    evo.add_argument("--dvs_numpy", default=None)
    evo.add_argument("--davis_output", action="store_true",
                     help="(unsupported, like the reference's synthetic path: warns and continues)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def emulator_config(args) -> EmulatorConfig:
    cfg = EmulatorConfig.preset(args.dvs_params)
    overrides = {}
    for name, field in [
        ("pos_thres", "pos_thres"), ("neg_thres", "neg_thres"), ("sigma_thres", "sigma_thres"),
        ("cutoff_hz", "cutoff_hz"), ("leak_rate_hz", "leak_rate_hz"), ("shot_noise_rate_hz", "shot_noise_rate_hz"),
        ("refractory_period", "refractory_period_s"), ("leak_jitter_fraction", "leak_jitter_fraction"),
        ("noise_rate_cov_decades", "noise_rate_cov_decades"), ("dvs_max_iters", "max_iters"),
    ]:
        v = getattr(args, name)
        if v is not None:
            overrides[field] = v
    return dataclasses.replace(cfg, **overrides)


def synthetic_source(spec: str, width: int | None, height: int | None) -> SyntheticInput:
    """``pkg.module`` (its first SyntheticInput subclass, the reference's
    convention) or ``pkg.module:ClassName``."""
    mod_name, _, cls_name = spec.partition(":")
    mod = importlib.import_module(mod_name)
    if cls_name:
        cls = getattr(mod, cls_name)
    else:
        cls = next(v for v in vars(mod).values()
                   if isinstance(v, type) and issubclass(v, SyntheticInput) and v is not SyntheticInput)
    return cls(width=width or 346, height=height or 260)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_slomo(args, device: torch.device):
    from ..events import slomo as S

    if args.slomo_model:
        ckpt = torch.load(args.slomo_model, map_location="cpu")
        channels = S.checkpoint_channels(ckpt)
        if channels != 1:
            raise ValueError(f"{args.slomo_model}: a SuperSloMo checkpoint for {channels}-channel frames; "
                             "v2e interpolates luma and needs a 1-channel checkpoint")
        model = S.load_checkpoint(S.SuperSloMo(1, device="cpu"), ckpt).to(device)
        print(f"loaded SuperSloMo weights from {args.slomo_model}")
        return model
    return S.SuperSloMo(1, device=device, generator=torch.Generator().manual_seed(args.seed))


def upsample_frames(frames: torch.Tensor, model, upsample: int, use_auto: bool, batch_size: int):
    """SuperSloMo over (N, H, W) float32 luma frames on the model's device:
    frames edge-padded to multiples of 32 (the UNet's skips), ``batch_size``
    source pairs a call, each pair giving ``upsample`` midpoint frames
    (t = (i + 0.5) / U; the source frames are not re-emitted). With
    ``use_auto``: one global factor from the largest |flow| over all pairs.
    Returns ((N - 1) * U, H, W) frames and the factor."""
    from ..events import slomo as S

    n, h, w = frames.shape
    ph, pw = (-h) % 32, (-w) % 32
    padded = F.pad(frames[:, None], (0, pw, 0, ph), mode="replicate")[:, 0] if ph or pw else frames
    def pair(i: int):
        sl = padded[i:i + batch_size + 1]
        sl = (sl / sl.new_full((), 255.0))[..., None]
        m = min(batch_size, sl.shape[0] - 1)
        return sl[:m], sl[1:m + 1]

    with torch.inference_mode():
        if use_auto:
            mf = torch.zeros((), device=frames.device)
            for i in range(0, n - 1, batch_size):
                a, b = pair(i)
                mf = torch.maximum(mf, model.flow(a, b).abs().max())
            mf = float(mf)
            upsample = max(upsample, S.auto_upsampling_factor(mf))
            print(f"auto timestamp resolution: max flow {mf:.2f} px -> upsampling {upsample}x")
        ts = S.midpoint_times(upsample, frames.device)
        out = []
        for i in range(0, n - 1, batch_size):
            a, b = pair(i)
            mids = model.interpolate(a, b, ts)  # (U, B, H, W, C)
            mids = mids[..., 0]
            out.append(mids.transpose(0, 1).reshape(-1, *mids.shape[2:])[:, :h, :w] * 255.0)
    return torch.cat(out), upsample


def simulate(frames: torch.Tensor, timestamps: np.ndarray, cfg: EmulatorConfig, seed: int, chunk: int,
             render_mode: str | None, dur_exposure: float | None, dur_num_out: int, device: torch.device):
    """The emulator over frames[1:] in chunks, state carried; per chunk the
    dense maps become sparse events on the device, and DURATION windows
    accumulate there. COUNT / AREA_COUNT maps are staged to host memory
    (their windows close on global counts). Returns a namespace with the
    events, the duration sum, the staged maps, the counts and timings."""
    t_emu = t_sparse = t_render = 0.0
    state = init_state(frames[0], cfg, seed=seed)
    total_events = torch.zeros((), dtype=torch.int64, device=device)
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    ev_parts, map_parts, dur_acc_sum = [], [], None
    for i in range(1, frames.shape[0], chunk):
        t0 = time.perf_counter()
        t = torch.from_numpy(timestamps[i:i + chunk].astype(np.float32)).to(device)
        state, out = emulate_sequence(state, frames[i:i + chunk], t, cfg)
        total_events += out["num_events"].sum()
        overflow += out["overflow"].sum()
        _sync(device)
        t1 = time.perf_counter()
        ev_parts.append(ev_io.dense_to_events(out["pos"], out["neg"], out["ts"], out["iter_valid"]))
        t2 = time.perf_counter()
        if render_mode == "duration":
            acc = R.duration_acc(out["pos"], out["neg"], out["ts"], out["iter_valid"], 0.0, dur_exposure, dur_num_out)
            dur_acc_sum = acc if dur_acc_sum is None else dur_acc_sum + acc
        elif render_mode is not None:
            map_parts.append(tuple(out[k].cpu() for k in ("pos", "neg", "ts", "iter_valid")))
        _sync(device)
        t3 = time.perf_counter()
        t_emu, t_sparse, t_render = t_emu + t1 - t0, t_sparse + t2 - t1, t_render + t3 - t2
        del out
    events = np.concatenate(ev_parts, axis=0) if ev_parts else np.zeros((0, 4))
    return SimpleNamespace(events=events, dur_acc_sum=dur_acc_sum, map_parts=map_parts, state=state,
                           total_events=int(total_events), overflow=int(overflow),
                           seconds={"emulate": t_emu, "dense_to_events": t_sparse, "render": t_render})


def render_outputs(args, sim, render_mode: str, dur_exposure, dur_num_out: int, device: torch.device):
    """The event frames (K, H, W) uint8 on the device and their end times,
    empty windows dropped by ``isfinite``."""
    if render_mode == "duration":
        imgs = R.finalize_duration(sim.dur_acc_sum, args.dvs_vid_full_scale)
        times = (np.arange(dur_num_out) + 1) * dur_exposure
    else:
        pos_m, neg_m, ts_m, iv_m = (torch.cat([p[k] for p in sim.map_parts]).to(device) for k in range(4))
        if render_mode == "count":
            count = int(args.dvs_exposure[1])
            imgs, times = R.render_count(pos_m, neg_m, ts_m, iv_m, count, max(sim.total_events // max(count, 1), 1),
                                         full_scale_count=args.dvs_vid_full_scale)
        else:
            count, dim = int(args.dvs_exposure[1]), int(args.dvs_exposure[2])
            imgs, times = R.render_area_count(pos_m, neg_m, ts_m, iv_m, count, dim, 64,
                                              full_scale_count=args.dvs_vid_full_scale)
        times = times.cpu().numpy()
    times = np.atleast_1d(times)
    keep = np.isfinite(times)
    imgs = imgs[torch.from_numpy(keep).to(imgs.device)]
    return imgs, (imgs * 255).to(torch.uint8), times[keep]


def main(argv: Sequence[str] | None = None) -> SimpleNamespace:
    """The command; also a function: returns the events (N, 4), the event
    frames (float in [0, 1] and uint8, on the device), their end times and
    the run's counts and seconds."""
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.input is None and args.synthetic_input is None:
        ap.error("one of --input / --synthetic_input is required")
    if args.davis_output:
        print("WARNING: --davis_output is not supported; continuing without it")

    out_folder = resolve_output_folder(args)
    os.makedirs(out_folder, exist_ok=True)
    with open(os.path.join(out_folder, "info.txt"), "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k}: {v}\n")

    t_start = time.perf_counter()
    seconds = {}
    out_w, out_h = set_output_dimension(args)
    # a slow-motion source (factor > 1) stands for a higher real frame rate (v2e.py:343)
    in_rate = args.input_frame_rate * max(args.input_slowmotion_factor, 1e-9)
    if args.synthetic_input:
        src = synthetic_source(args.synthetic_input, out_w, out_h)
        frames, _ = src.frames_array()
        frames = np.asarray(frames, np.float32)
        in_rate = src.frame_rate
    else:
        frames = load_frames(args.input, out_h, out_w)

    if args.start_time is not None or args.stop_time is not None:
        # windowing is in playback time: the raw source fps (v2e.py:329-332)
        play_rate = args.input_frame_rate
        i0 = int((args.start_time or 0.0) * play_rate)
        i1 = int(args.stop_time * play_rate) if args.stop_time is not None else len(frames)
        frames = frames[max(i0, 0):max(i1, i0 + 2)]
    if args.crop is not None:
        left, right, top, bottom = args.crop
        h0, w0 = frames.shape[1:3]
        frames = frames[:, top:h0 - bottom or None, left:w0 - right or None]

    n, h, w = frames.shape
    print(f"loaded {n} frames of {w}x{h}")
    cfg = emulator_config(args)
    if args.vid_orig:
        write_avi(np.clip(frames, 0, 255), os.path.join(out_folder, args.vid_orig), args.avi_frame_rate)
    frames = torch.from_numpy(np.ascontiguousarray(frames)).to(device)

    upsample = max(args.slomo_upsample, 1)
    if args.timestamp_resolution is not None and not args.disable_slomo:
        upsample = max(upsample, int(np.ceil(1.0 / (in_rate * args.timestamp_resolution))))
    use_auto = args.auto_timestamp_resolution and not args.disable_slomo
    if args.disable_slomo:
        upsample = 1
    num_pairs = 0
    if upsample > 1 or use_auto:
        t0 = time.perf_counter()
        model = load_slomo(args, device)
        _sync(device)
        t1 = time.perf_counter()
        frames, upsample = upsample_frames(frames, model, upsample, use_auto, args.batch_size)
        _sync(device)
        seconds["slomo_load"], seconds["slomo"] = t1 - t0, time.perf_counter() - t1
        num_pairs = n - 1
        n = frames.shape[0]
        print(f"slomo upsampled to {n} frames"
              + ("" if args.slomo_model else " (untrained weights — pass --slomo_model for real interpolation)"))
        if args.vid_slomo:
            write_avi(np.clip(frames.cpu().numpy(), 0, 255), os.path.join(out_folder, args.vid_slomo),
                      args.avi_frame_rate)

    dt = 1.0 / (in_rate * max(upsample, 1))
    timestamps = np.arange(n) * dt
    check_lowpass(cfg.cutoff_hz, 1.0 / dt)
    f32_ulp = float(np.spacing(np.float32(timestamps[-1]))) if n > 1 else 0.0
    if f32_ulp > 0.01 * dt:
        print(f"WARNING: float32 timestamp resolution at t={timestamps[-1]:.1f}s is {f32_ulp:.2e}s = "
              f"{f32_ulp / dt:.1%} of the {dt:.2e}s frame interval; event timestamps will quantize. Process the "
              "stream in shorter --start_time/--stop_time windows.", file=sys.stderr)

    seed = args.dvs_emulator_seed if args.dvs_emulator_seed is not None else args.seed
    render_mode, dur_exposure, dur_num_out = None, None, 0
    if not args.no_frames:
        render_mode = args.dvs_exposure[0]
        if args.frame_rate is not None:
            render_mode, dur_exposure = "duration", 1.0 / args.frame_rate
        elif render_mode == "duration":
            dur_exposure = float(args.dvs_exposure[1])
        if render_mode == "duration":
            dur_num_out = max(int(np.ceil(timestamps[-1] / dur_exposure)), 1)
    sim = simulate(frames, timestamps, cfg, seed, max(int(args.dvs_frame_chunk), 1), render_mode, dur_exposure,
                   dur_num_out, device)
    seconds.update(sim.seconds)
    if sim.overflow > 0:
        print(f"WARNING: {sim.overflow} events were clipped by the static max_iters={cfg.max_iters} cap (deferred "
              "to later frames; timestamps skew by up to one frame interval). Raise --dvs_max_iters or the SloMo "
              "upsampling.", file=sys.stderr)
    sim_time = time.perf_counter() - t_start
    video_time = timestamps[-1]
    print(f"emulated {sim.total_events} events over {video_time:.3f}s of video in {sim_time:.2f}s wall "
          f"({sim_time / max(video_time, 1e-9):.1f}x real time)")

    events = sim.events
    t0 = time.perf_counter()
    if args.dvs_text:
        ev_io.write_events_csv(events, os.path.join(out_folder, args.dvs_text))
    if args.dvs_h5:
        ev_io.write_events_h5(events, os.path.join(out_folder, args.dvs_h5))
    if args.dvs_numpy:
        np.save(os.path.join(out_folder, args.dvs_numpy), np.asarray(events))
    if args.dvs_aedat2:
        # the smallest jAER geometry that fits; no silent fallback (an
        # undersized geometry corrupts the packed y addresses)
        fits = sorted((sz for sz in ev_io.AEDAT2_SIZES if sz[0] >= w and sz[1] >= h), key=lambda sz: sz[0] * sz[1])
        if not fits:
            raise SystemExit(f"--dvs_aedat2: no supported AEDAT2 camera geometry fits {w}x{h} "
                             f"(supported: {sorted(ev_io.AEDAT2_SIZES)})")
        wr = ev_io.AEDat2Writer(os.path.join(out_folder, args.dvs_aedat2), *fits[0])
        wr.append(events)
        wr.close()
    seconds["write_events"] = time.perf_counter() - t0

    imgs = u8 = times = None
    if not args.no_frames:
        t0 = time.perf_counter()
        imgs, u8, times = render_outputs(args, sim, render_mode, dur_exposure, dur_num_out, device)
        _sync(device)
        seconds["render"] = seconds.get("render", 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()
        import cv2

        frames_dir = os.path.join(out_folder, "event-frames")
        os.makedirs(frames_dir, exist_ok=True)
        u8_host = u8.cpu().numpy()
        for img, t in zip(u8_host, times):
            cv2.imwrite(os.path.join(frames_dir, f"{t * 1e3:.0f}.bmp"), cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
        print(f"wrote event frames to {frames_dir}")
        if len(u8_host) and not args.skip_video_output:
            avi = os.path.join(out_folder, args.dvs_vid)
            write_avi(u8_host, avi, args.avi_frame_rate)
            print(f"wrote {avi}")
        seconds["write_frames"] = time.perf_counter() - t0

    # end-of-run desktop integration (v2e.py:793-808): no-ops on a headless host
    from ..events import desktop

    desktop.notify("v2e done", f"{sim.total_events} events -> {out_folder}")
    if not args.skip_video_output and not args.no_preview:
        desktop.open(os.path.abspath(out_folder))
    return SimpleNamespace(events=events, event_frames=imgs, event_frames_u8=u8, frame_times=times,
                           num_events=sim.total_events, overflow=sim.overflow, num_frames=n, num_pairs=num_pairs,
                           upsample=upsample, seconds=seconds, output_folder=out_folder, config=cfg,
                           state=sim.state, timestamps=timestamps, frames=frames)


if __name__ == "__main__":
    main()
