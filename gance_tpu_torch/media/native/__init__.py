"""
ctypes binding of the native AVI muxer (`native/avi_muxer.cpp` at the root of
the repository), the port's own.

The shared library is built at first use with
`g++ -O2 -fPIC -shared -std=c++17` from that source into `build/` beside this
file (listed in .gitignore); its name carries a hash of the source and the
flags, so a changed source builds anew. Only g++ is needed: no make, and no
library from elsewhere in the checkout.

  * `RawAviWriter`: uncompressed (BI_RGB) AVI frames through the muxer's
    O_DIRECT writer, segmented below AVI's 4 GiB RIFF limit. Given PCM16
    samples and their rate, it also carries an audio stream: after each frame
    it writes that frame's share of the samples (rate / fps of them), so
    every segment holds the audio of its own frames, and `finalize` appends
    what is left to the last segment.
  * `AviWriter` and `mux_video_with_audio`: MJPEG + PCM16 (cv2, imported
    where used, encodes the JPEGs and decodes the source video).
  * `raw_avi_info` and `raw_avi_frames`: a RIFF reader of the uncompressed
    AVIs that `RawAviWriter` writes (this package's or gance_tpu's, one
    muxer source), in plain Python and numpy, streaming a frame at a time.
    Resumable renders read their raw parts back with it and the spill tools
    read spills with it, so neither depends on a decoder's handling of
    BI_RGB rows (top-down by a negative height, BGR, padded to 4 bytes).
"""

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import BinaryIO, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from gance_tpu_torch.utils.logging import LOGGER

SOURCE = Path(__file__).resolve().parents[3] / "native" / "avi_muxer.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgance_media-{digest}.so"


def build_library() -> Path:
    """Compile the muxer if its library is missing; returns the library's path."""
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    LOGGER.info("Building the native AVI muxer into %s", target)
    result = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{result.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build never loads half a file
    return target


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.avi_create.restype = ctypes.c_void_p
    lib.avi_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.avi_create_ex.restype = ctypes.c_void_p
    lib.avi_create_ex.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.avi_write_video_frame.restype = ctypes.c_int
    lib.avi_write_video_frame.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
    ]
    lib.avi_write_video_frame_raw_rgb.restype = ctypes.c_int
    lib.avi_write_video_frame_raw_rgb.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    ]
    lib.avi_write_video_frame_raw_bgr.restype = ctypes.c_int
    lib.avi_write_video_frame_raw_bgr.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    ]
    lib.avi_bytes_written.restype = ctypes.c_int64
    lib.avi_bytes_written.argtypes = [ctypes.c_void_p]
    lib.avi_write_audio.restype = ctypes.c_int
    lib.avi_write_audio.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int
    ]
    lib.avi_finalize.restype = ctypes.c_int
    lib.avi_finalize.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _write_pcm(lib: ctypes.CDLL, ctx, samples: np.ndarray) -> None:
    """Append interleaved int16 PCM as one audio chunk."""
    data = np.ascontiguousarray(samples, np.int16).reshape(-1)
    if data.size and lib.avi_write_audio(
        ctx, data.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), data.size
    ) != 0:
        raise IOError("AVI audio chunk write failed")


class AviWriter:
    """Streaming MJPEG+PCM16 AVI writer over the native muxer (JPEGs by cv2)."""

    def __init__(
        self,
        path: Path,
        width: int,
        height: int,
        fps: float,
        audio_rate: int = 0,
        audio_channels: int = 0,
        jpeg_quality: int = 95,
    ) -> None:
        self._lib = _load_library()
        self._ctx = self._lib.avi_create(
            str(path).encode(), width, height, float(fps), audio_rate, audio_channels
        )
        if not self._ctx:
            raise ValueError(f"Couldn't create AVI file at {path}")
        self._quality = jpeg_quality

    def write_frame_bgr(self, frame: np.ndarray) -> None:
        """Encode a BGR uint8 frame (cv2's native order) as JPEG and append it."""
        import cv2

        ok, jpeg = cv2.imencode(
            ".jpg", np.asarray(frame, np.uint8),
            [cv2.IMWRITE_JPEG_QUALITY, self._quality],
        )
        if not ok:
            raise ValueError("JPEG encode failed")
        data = np.ascontiguousarray(jpeg.reshape(-1))
        self._lib.avi_write_video_frame(
            self._ctx, data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), data.size
        )

    def write_frame_rgb(self, frame: np.ndarray) -> None:
        """Encode an RGB uint8 frame as JPEG and append it."""
        import cv2

        self.write_frame_bgr(cv2.cvtColor(np.asarray(frame, np.uint8), cv2.COLOR_RGB2BGR))

    def write_audio(self, samples: np.ndarray) -> None:
        """Append interleaved int16 PCM samples."""
        _write_pcm(self._lib, self._ctx, samples)

    def finalize(self) -> None:
        if self._ctx:
            self._lib.avi_finalize(self._ctx)
            self._ctx = None


class RawAviWriter:
    """
    Uncompressed (BI_RGB) AVI writer for maximum-rate egress: frames are
    appended as raw top-down BGR rows through the muxer's O_DIRECT buffered
    writer (a plain buffered write where the filesystem refuses O_DIRECT).

    AVI's RIFF size field caps one file at 4 GiB, so the writer segments:
    `out.avi`, `out.part001.avi`, `out.part002.avi`, ... Each segment is a
    complete AVI that plays on its own.

    With `pcm` ((S,) or (S, channels) int16) and `audio_rate`, each segment
    also has a PCM16 audio stream: every frame is followed by the next
    round(audio_rate / fps) samples, and `finalize` writes any samples left
    after the last frame into the last segment.
    """

    SEGMENT_BYTES_DEFAULT = int(3.5 * 1024**3)

    def __init__(
        self,
        path: Path,
        width: int,
        height: int,
        fps: float,
        direct_io: bool = True,
        segment_bytes: int = SEGMENT_BYTES_DEFAULT,
        pcm: Optional[np.ndarray] = None,
        audio_rate: int = 0,
    ) -> None:
        # RIFF sizes and idx1 offsets are uint32: past 4 GiB they silently wrap
        # and the segment becomes unplayable, so refuse budgets near the limit.
        if segment_bytes > int(3.9 * 1024**3):
            raise ValueError(
                f"segment_bytes {segment_bytes} exceeds the AVI uint32 ceiling; "
                "use <= 3.9 GiB per segment"
            )
        self._lib = _load_library()
        self._base = Path(path)
        self._width = int(width)
        self._height = int(height)
        self._fps = float(fps)
        self._direct_io = direct_io
        self._segment_bytes = int(segment_bytes)
        stride = (self._width * 3 + 3) & ~3
        self._frame_bytes = stride * self._height + 24  # chunk header + idx1 entry
        if pcm is not None and audio_rate > 0:
            pcm = np.asarray(pcm, np.int16)
            self._pcm = np.ascontiguousarray(pcm[:, None] if pcm.ndim == 1 else pcm)
            self._audio_rate = int(audio_rate)
            self._samples_per_frame = int(round(self._audio_rate / self._fps))
        else:
            self._pcm = np.zeros((0, 0), np.int16)
            self._audio_rate = 0
            self._samples_per_frame = 0
        self._cursor = 0
        self._segment_index = 0
        self.segment_paths: List[Path] = []
        self._ctx = self._open_segment()

    def _segment_path(self, index: int) -> Path:
        if index == 0:
            return self._base
        return self._base.with_name(
            f"{self._base.stem}.part{index:03d}{self._base.suffix}"
        )

    def _open_segment(self):
        path = self._segment_path(self._segment_index)
        ctx = self._lib.avi_create_ex(
            str(path).encode(), self._width, self._height, self._fps,
            self._audio_rate, self._pcm.shape[1] if self._audio_rate else 0,
            1, 1 if self._direct_io else 0,
        )
        if not ctx:
            raise ValueError(f"Couldn't create raw AVI segment at {path}")
        self.segment_paths.append(path)
        return ctx

    def _next_audio(self) -> np.ndarray:
        return self._pcm[self._cursor : self._cursor + self._samples_per_frame]

    def _roll_if_needed(self) -> None:
        audio = self._next_audio()
        audio_bytes = 24 + audio.nbytes if audio.size else 0
        used = int(self._lib.avi_bytes_written(self._ctx))
        if used + self._frame_bytes + audio_bytes > self._segment_bytes:
            if self._lib.avi_finalize(self._ctx) != 0:
                self._ctx = None
                raise IOError(
                    f"finalizing raw AVI segment {self.segment_paths[-1]} failed "
                    "(disk full?)"
                )
            self._segment_index += 1
            self._ctx = self._open_segment()

    def _checked(self, frame: np.ndarray) -> np.ndarray:
        frame = np.ascontiguousarray(np.asarray(frame, np.uint8))
        if frame.shape != (self._height, self._width, 3):
            raise ValueError(
                f"frame {frame.shape} != declared {(self._height, self._width, 3)}"
            )
        return frame

    def _after_frame(self, rc: int) -> None:
        if rc != 0:
            raise IOError("raw AVI frame write failed")
        audio = self._next_audio()
        _write_pcm(self._lib, self._ctx, audio)
        self._cursor += audio.shape[0]

    def write_frame_rgb(self, frame: np.ndarray) -> None:
        """Append a top-down RGB uint8 (H, W, 3) frame (BGR swizzle in native)."""
        frame = self._checked(frame)
        self._roll_if_needed()
        self._after_frame(self._lib.avi_write_video_frame_raw_rgb(
            self._ctx, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        ))

    def write_frame_bgr(self, frame: np.ndarray) -> None:
        """Append a frame already in top-down BGR order (a pure memcpy)."""
        frame = self._checked(frame)
        self._roll_if_needed()
        self._after_frame(self._lib.avi_write_video_frame_raw_bgr(
            self._ctx, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        ))

    def finalize(self) -> None:
        if self._ctx:
            try:
                # the samples past the last frame, in chunks the C int can count
                step = 1 << 20
                while self._cursor < self._pcm.shape[0]:
                    _write_pcm(self._lib, self._ctx, self._pcm[self._cursor : self._cursor + step])
                    self._cursor += step
            finally:
                rc = self._lib.avi_finalize(self._ctx)
                self._ctx = None
            if rc != 0:
                raise IOError(
                    f"finalizing raw AVI {self.segment_paths[-1]} failed: the tail "
                    "flush or header patches did not land (disk full?)"
                )


def _audio_as_int16(path: Path) -> Tuple[int, np.ndarray]:
    """A WAV file's sample rate and its samples as int16 PCM."""
    from scipy.io import wavfile

    rate, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        pcm = data
    elif data.dtype == np.int32:
        pcm = (data / 65536).astype(np.int16)
    elif data.dtype in (np.float32, np.float64):
        pcm = np.clip(data * 32767.0, -32768, 32767).astype(np.int16)
    elif data.dtype == np.uint8:
        pcm = ((data.astype(np.int16) - 128) * 256).astype(np.int16)
    else:
        raise ValueError(f"Unsupported wav dtype {data.dtype}")
    return rate, pcm


def concatenated_pcm16(audio_paths: Sequence[Path]) -> Tuple[int, np.ndarray]:
    """(rate, (S, channels) int16) of WAV files played one after another; they
    must share a sample rate. No paths: (0, an empty array)."""
    rates_pcm = [_audio_as_int16(Path(p)) for p in audio_paths]
    rates = {r for r, _ in rates_pcm}
    if len(rates) > 1:
        raise ValueError("Audio tracks must share a sample rate for native muxing")
    if not rates_pcm:
        return 0, np.zeros((0, 1), np.int16)
    pcm = np.concatenate([p if p.ndim > 1 else p[:, None] for _, p in rates_pcm])
    return rates.pop(), pcm


def mux_video_with_audio(
    video_path: Path, audio_paths: List[Path], output_path: Path
) -> None:
    """
    Re-mux an existing video file with concatenated audio tracks into an MJPEG+PCM
    AVI: frames are re-encoded as JPEG (quality 95) by cv2, audio as PCM16,
    interleaved one frame's worth at a time.
    """
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise ValueError(f"Couldn't open {video_path}")
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    rate, pcm = concatenated_pcm16(audio_paths)
    channels = pcm.shape[1] if pcm.size else 0

    out = Path(output_path)
    if out.suffix.lower() != ".avi":
        LOGGER.warning(
            "Native mux writes AVI content; output %s keeps its requested name.", out
        )
    writer = AviWriter(out, width, height, fps, audio_rate=rate, audio_channels=channels)

    samples_per_frame = int(round(rate / fps)) if rate else 0
    cursor = 0
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            writer.write_frame_bgr(frame)  # cv2 decodes BGR; no roundtrip
            if samples_per_frame and cursor < pcm.shape[0]:
                writer.write_audio(pcm[cursor : cursor + samples_per_frame])
                cursor += samples_per_frame
        if cursor < pcm.shape[0]:
            writer.write_audio(pcm[cursor:])
    finally:
        cap.release()
        writer.finalize()


class RawAviInfo(NamedTuple):
    """What the headers of an uncompressed AVI say."""

    width: int
    height: int
    fps: float
    frame_count: int
    top_down: bool
    movi: Tuple[int, int]  # (first chunk offset, end) of the 'movi' list


def _riff_chunks(handle: BinaryIO, offset: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(chunk id, body offset, body length) of the chunks in [offset, end);
    a LIST is yielded with its list type as the id (b'LIST' + type)."""
    while offset + 8 <= end:
        handle.seek(offset)
        cid, length = struct.unpack("<4sI", handle.read(8))
        body = offset + 8
        if cid == b"LIST":
            yield b"LIST" + handle.read(4), body + 4, length - 4
        else:
            yield cid, body, length
        offset = body + length + (length & 1)


def raw_avi_info(path: Path) -> RawAviInfo:
    """Read the headers of the uncompressed (BI_RGB, 24-bit) AVI at `path`;
    raises on anything else."""
    with open(str(path), "rb") as handle:
        riff, size, form = struct.unpack("<4sI4s", handle.read(12))
        if riff != b"RIFF" or form != b"AVI ":
            raise ValueError(f"{path} is not an AVI file")
        end = min(8 + size, os.fstat(handle.fileno()).st_size)
        found = {}
        for cid, body, length in _riff_chunks(handle, 12, end):
            if cid == b"LISThdrl":
                for sub, sbody, slength in _riff_chunks(handle, body, body + length):
                    if sub == b"avih":
                        handle.seek(sbody)
                        fields = struct.unpack("<10I", handle.read(40))
                        found.update(frames=fields[4], width=fields[8], height=fields[9])
                    elif sub == b"LISTstrl" and "fps" not in found:
                        for leaf, lbody, _ in _riff_chunks(handle, sbody, sbody + slength):
                            handle.seek(lbody)
                            if leaf == b"strh":
                                kind, _, _, _, _, _, scale, rate = struct.unpack(
                                    "<4s4sIHHIII", handle.read(28))
                                if kind != b"vids":
                                    break
                                found["fps"] = rate / scale
                            elif leaf == b"strf":
                                _, _, height, _, bits, compression = struct.unpack(
                                    "<IiiHHI", handle.read(20))
                                if bits != 24 or compression != 0:
                                    raise ValueError(
                                        f"{path} is not an uncompressed 24-bit AVI "
                                        f"(bit count {bits}, compression {compression})")
                                found["top_down"] = height < 0
            elif cid == b"LISTmovi":
                found["movi"] = (body, body + length)
    missing = {"frames", "width", "height", "fps", "top_down", "movi"} - set(found)
    if missing:
        raise ValueError(f"{path}: AVI headers lack {sorted(missing)}")
    return RawAviInfo(found["width"], found["height"], found["fps"], found["frames"],
                      found["top_down"], found["movi"])


def raw_avi_frames(path: Path) -> Iterator[np.ndarray]:
    """The frames of the uncompressed AVI at `path` as top-down RGB uint8
    (H, W, 3) arrays, read one chunk at a time. The audio chunks are skipped."""
    info = raw_avi_info(path)
    stride = (info.width * 3 + 3) & ~3
    with open(str(path), "rb") as handle:
        for cid, body, length in _riff_chunks(handle, *info.movi):
            if cid != b"00db":
                continue
            if length != stride * info.height:
                raise ValueError(f"{path}: a frame chunk of {length} bytes for "
                                 f"{info.width}x{info.height}")
            handle.seek(body)
            rows = np.frombuffer(handle.read(length), np.uint8).reshape(info.height, stride)
            bgr = rows[:, : info.width * 3].reshape(info.height, info.width, 3)
            if not info.top_down:
                bgr = bgr[::-1]
            yield np.ascontiguousarray(bgr[..., ::-1])
