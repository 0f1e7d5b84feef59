"""The port's wire protocol against the JAX package's and ``msgpack``.

``send_slam_tpu_torch/io/msgpack_codec.py`` must pack byte for byte as
``msgpack.packb(obj, use_bin_type=True)`` and unpack every width
``msgpack`` writes (float32 included); ``frame_packet_bytes`` of every
packet builder must equal the JAX package's; ``PacketDecoder``, ``ppm``
and ``native`` (with the native library and with its numpy fallback)
must return what the JAX modules return. Exact equality throughout:
this is byte-level host code.
"""

import struct

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from send_slam_tpu.io import native as jnative
from send_slam_tpu.io import ppm as jppm
from send_slam_tpu.io import protocol as jproto
from send_slam_tpu_torch.io import msgpack_codec
from send_slam_tpu_torch.io import native as tnative
from send_slam_tpu_torch.io import ppm as tppm
from send_slam_tpu_torch.io import protocol as tproto
from send_slam_tpu_torch.ops.cuda_build import NativeLibrary

RNG = np.random.default_rng(9)


def ref_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


# Each boundary of every integer width, both signs.
INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**63, 2**64 - 1, -1, -31, -32, -33, -127, -128, -129,
             -32767, -32768, -32769, -2**31 + 1, -2**31, -2**31 - 1,
             -2**63 + 1, -2**63]
# Lengths at each str / bin / array / map header boundary.
LEN_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


class TestCodecPacking:
    @pytest.mark.parametrize("v", INT_EDGES)
    def test_int_widths(self, v):
        assert msgpack_codec.packb(v) == ref_pack(v)
        assert msgpack_codec.unpackb(ref_pack(v)) == v

    @pytest.mark.parametrize("n", LEN_EDGES)
    def test_container_widths(self, n):
        for obj in ("x" * n, "é" * (n // 2), b"\x07" * n, list(range(n)),
                    {f"k{i}": i for i in range(n)}, tuple([None] * n)):
            assert msgpack_codec.packb(obj) == ref_pack(obj), (type(obj), n)

    def test_scalars(self):
        for v in (None, True, False, 0.0, -0.0, 1.5, -2.25e300, 1e-310,
                  float("inf"), float("-inf"), np.float64(3.25),
                  bytearray(b"ab"), memoryview(b"cd")):
            assert msgpack_codec.packb(v) == ref_pack(v), v
        nan = msgpack_codec.packb(float("nan"))
        assert nan == ref_pack(float("nan"))

    def test_refuses_what_msgpack_refuses(self):
        for bad in (2**64, -2**63 - 1):
            with pytest.raises(OverflowError):
                msgpack_codec.packb(bad)
        for bad in (object(), np.int64(3), {1, 2}):
            with pytest.raises(TypeError):
                msgpack_codec.packb(bad)

    @settings(max_examples=200, deadline=None)
    @given(st.recursive(
        st.none() | st.booleans()
        | st.integers(min_value=-2**63, max_value=2**64 - 1)
        | st.floats(allow_nan=False) | st.text(max_size=40)
        | st.binary(max_size=300),
        lambda kids: st.lists(kids, max_size=20)
        | st.dictionaries(st.text(max_size=8), kids, max_size=20),
        max_leaves=60))
    def test_nested_payloads(self, obj):
        b = msgpack_codec.packb(obj)
        assert b == ref_pack(obj)
        assert msgpack_codec.unpackb(b) == msgpack.unpackb(b, raw=False)


class TestCodecUnpacking:
    def test_every_width_msgpack_writes(self):
        """float32 and the wider-than-needed forms the reference's peers
        may send, written by hand, and msgpack's own float32 packing."""
        cases = [
            (b"\xca" + struct.pack(">f", 1.5), 1.5),
            (b"\xcc\x05", 5), (b"\xcd\x00\x05", 5),
            (b"\xce\x00\x00\x00\x05", 5), (b"\xcf" + struct.pack(">Q", 5), 5),
            (b"\xd0\x05", 5), (b"\xd1\xff\xfb", -5),
            (b"\xd2" + struct.pack(">i", -5), -5),
            (b"\xd3" + struct.pack(">q", -5), -5),
            (b"\xd9\x02hi", "hi"), (b"\xda\x00\x02hi", "hi"),
            (b"\xdb\x00\x00\x00\x02hi", "hi"),
            (b"\xc4\x01z", b"z"), (b"\xc5\x00\x01z", b"z"),
            (b"\xc6\x00\x00\x00\x01z", b"z"),
            (b"\xdc\x00\x01\x01", [1]), (b"\xdd\x00\x00\x00\x01\x01", [1]),
            (b"\xde\x00\x01\xa1a\x01", {"a": 1}),
            (b"\xdf\x00\x00\x00\x01\xa1a\x01", {"a": 1}),
        ]
        for data, want in cases:
            assert msgpack.unpackb(data, raw=False) == want
            got = msgpack_codec.unpackb(data)
            assert got == want and type(got) is type(want), data
        f32 = msgpack.packb({"x": 0.1, "y": [2.5, -1e30]},
                            use_single_float=True)
        assert msgpack_codec.unpackb(f32) == msgpack.unpackb(f32)

    def test_refuses_ext_and_truncated_input(self):
        for ext in (msgpack.packb(msgpack.ExtType(1, b"abcd")),
                    msgpack.packb(msgpack.ExtType(2, b"x" * 300))):
            with pytest.raises(ValueError, match="ext"):
                msgpack_codec.unpackb(ext)
        whole = ref_pack({"frame": b"\x01" * 1000, "t": 1.25, "n": [1, 2]})
        for cut in (0, 1, 5, len(whole) // 2, len(whole) - 1):
            with pytest.raises(ValueError):
                msgpack_codec.unpackb(whole[:cut])
        for bad in (whole + b"\x00", b"\xc1", b"\x81\x91\x01\x02"):
            with pytest.raises(ValueError):
                msgpack_codec.unpackb(bad)


def all_packets():
    img = RNG.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    big = RNG.integers(0, 255, (480, 640, 3), dtype=np.uint8)
    calib = dict(camera_id=0, timestamp=1.0, width=640, height=480,
                 fx=517.3, fy=516.5, cx=318.6, cy=255.3)
    return [
        ("frame", dict(camera_id=0, timestamp=123.456, width=32, height=24,
                       frame=jppm.encode_ppm(img))),
        ("frame", dict(camera_id=3, timestamp=1e9 + 0.25, width=640,
                       height=480, frame=jppm.encode_ppm(big))),
        ("frame", dict(camera_id=1, timestamp=2, width=32, height=24,
                       frame=b"\xff\xd8jpeg", channels=1, encoding="jpeg")),
        ("calibration", calib),
        ("calibration", dict(calib, k1=-0.1, k2=0.01, p1=1e-4, p2=-2e-4,
                             k3=0.5, fps=60.0, rgb=0)),
        ("pose", dict(timestamp=2.0, camera_id=1, tracking_state=2,
                      position=(0.1, -0.2, 3e-8),
                      orientation=(0.0, 0.0, 0.0, 1.0))),
        ("pose", dict(timestamp=1700000000.123, camera_id=0,
                      tracking_state=4,
                      position=np.array([1.5, 2.5, -3.5], np.float32),
                      orientation=np.array([0.1, 0.2, 0.3, 0.9],
                                           np.float32))),
        ("terminate", {}),
    ]


BUILDERS = {"frame": "build_frame_packet",
            "calibration": "build_calibration_packet",
            "pose": "build_pose_packet", "terminate": "build_terminate_packet"}


class TestPackets:
    @pytest.mark.parametrize("case", range(len(all_packets())))
    def test_frame_packet_bytes_equal_jax(self, case):
        kind, kw = all_packets()[case]
        jp = getattr(jproto, BUILDERS[kind])(**kw)
        tp = getattr(tproto, BUILDERS[kind])(**kw)
        assert tp == jp
        tb = tproto.frame_packet_bytes(tp)
        assert tb == jproto.frame_packet_bytes(jp)
        assert tproto.PacketDecoder().feed(tb) == [msgpack.unpackb(
            tb[4:], raw=False)]

    def test_pose_ws_json_and_constants(self):
        pose = tproto.build_pose_packet(2.0, 1, 2, (0.1, 0.2, 0.3),
                                        (0.0, 0.0, 0.0, 1.0))
        assert tproto.pose_ws_json(pose) == jproto.pose_ws_json(pose)
        for name in dir(jproto):
            if name.startswith("TRACKING_") or name == "MAX_PACKET_BYTES":
                assert getattr(tproto, name) == getattr(jproto, name), name

    def test_oversize_packet_refused(self):
        with pytest.raises(ValueError, match="too large"):
            tproto.frame_packet_bytes({"frame": b"\0" * (50 * 2**20)})


class TestPacketDecoder:
    def stream(self):
        return b"".join(
            jproto.frame_packet_bytes(getattr(jproto, BUILDERS[k])(**kw))
            for k, kw in all_packets())

    @pytest.mark.parametrize("chunk", [1, 7, 4096, 1 << 20])
    def test_split_and_multi_packet_chunks(self, chunk):
        data = self.stream()
        jd, td = jproto.PacketDecoder(), tproto.PacketDecoder()
        jgot, tgot = [], []
        for i in range(0, len(data), chunk):
            jgot.extend(jd.feed(data[i:i + chunk]))
            tgot.extend(td.feed(data[i:i + chunk]))
        assert len(tgot) == len(all_packets())
        assert tgot == jgot

    def test_fifty_megabyte_guard(self):
        for dec in (jproto.PacketDecoder(), tproto.PacketDecoder()):
            with pytest.raises(ValueError, match="50 MB"):
                dec.feed(struct.pack(">I", tproto.MAX_PACKET_BYTES + 1)
                         + b"x")
        at_limit = struct.pack(">I", tproto.MAX_PACKET_BYTES) + b"x"
        assert tproto.PacketDecoder().feed(at_limit) == []


@pytest.fixture(params=["library", "numpy"])
def natives(request, monkeypatch):
    """Both packages' native modules, with the library (built) or forced
    onto the numpy fallback."""
    if request.param == "numpy":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    else:
        assert jnative.available() and tnative.available()
    return jnative, tnative


class TestPpmAndNative:
    def images(self):
        return [RNG.integers(0, 256, (48, 64, 3), dtype=np.uint8),
                RNG.integers(0, 256, (20, 30), dtype=np.uint8),
                np.repeat(np.arange(256, dtype=np.uint8).reshape(16, 16,
                                                                 1), 3, 2),
                np.zeros((1, 1, 3), np.uint8)]

    def test_ppm_module(self):
        for img in self.images():
            data = tppm.encode_ppm(img)
            assert data == jppm.encode_ppm(img)
            assert np.array_equal(tppm.decode_ppm(data), jppm.decode_ppm(data))
            if img.ndim == 3:
                assert np.array_equal(tppm.rgb_to_gray_u8(img),
                                      jppm.rgb_to_gray_u8(img))
        commented = b"P5\n# made by hand\n2 1\n255\n\x01\x02"
        assert np.array_equal(tppm.decode_ppm(commented), [[1, 2]])
        for bad in (b"P3\n1 1\n255\n", b"P6\n1 1\n65535\n\0\0\0\0\0\0"):
            with pytest.raises(ValueError):
                tppm.decode_ppm(bad)
        with pytest.raises(ValueError):
            tppm.encode_ppm(np.zeros((2, 2), np.float32))

    def test_native_equals_jax(self, natives):
        jn, tn = natives
        for img in self.images():
            data = jppm.encode_ppm(img)
            assert np.array_equal(tn.decode_ppm_gray(data),
                                  jn.decode_ppm_gray(data))
            assert tn.encode_ppm(img) == jn.encode_ppm(img)
            if img.ndim == 3:
                assert np.array_equal(tn.rgb_to_gray(img), jn.rgb_to_gray(img))
        # A gray frame sent as P6 (each value in three channels) decodes
        # back to itself, whichever implementation runs.
        gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
        rgb = np.repeat(gray[..., None], 3, axis=2)
        assert np.array_equal(tn.decode_ppm_gray(tn.encode_ppm(rgb)), gray)
        with pytest.raises(ValueError):
            tn.decode_ppm_gray(b"not a ppm at all")

    def test_extract_packets_equals_jax(self, natives):
        jn, tn = natives
        bodies = [b"hello", b"", b"x" * 1000]
        stream = b"".join(struct.pack(">I", len(b)) + b for b in bodies)
        stream += struct.pack(">I", 10) + b"abc"
        for buf, kw in ((stream, {}), (stream, dict(max_packets=2)),
                        (b"\x00\x00", {})):
            assert tn.extract_packets_native(buf, **kw) \
                == jn.extract_packets_native(buf, **kw)
        assert tn.extract_packets_native(stream)[0] == bodies
        for mod in (jn, tn):
            with pytest.raises(ValueError):
                mod.extract_packets_native(struct.pack(">I", 60 * 2**20)
                                           + b"x")

    def test_library_builds_into_the_port(self):
        assert tnative.available()
        path = tnative.LIBRARY.path()
        assert path.exists() and path.parent.name == "_build"
        assert path.parent.parent.name == "send_slam_tpu_torch"

    def test_shared_builder_names_and_reports(self, tmp_path):
        """The host I/O library through the port's one builder: its file
        is named by a hash of the source and the flags, and the
        compiler's report is kept beside it."""
        assert tnative.available()
        lib = tnative.LIBRARY
        assert lib.path().with_suffix(".log").exists()
        assert lib.report() == lib.path().with_suffix(".log").read_text()
        src = tmp_path / "hostio.cc"
        src.write_bytes(lib.source.read_bytes())

        def other(source, flags):
            return NativeLibrary(source, flags, tnative._bind,
                                 compiler=lambda: "g++")

        assert other(src, lib.flags).path().name == lib.path().name
        src.write_bytes(lib.source.read_bytes() + b"\n")
        names = {lib.path().name, other(src, lib.flags).path().name,
                 other(lib.source, [*lib.flags, "-DNDEBUG"]).path().name}
        assert len(names) == 3
        assert all(n.startswith("hostio_") and n.endswith(".so")
                   for n in names)

    @pytest.mark.parametrize("cxx", ["missing", "failing"])
    def test_numpy_fallback_without_a_compiler(self, cxx, tmp_path,
                                               monkeypatch, caplog):
        """A compiler that is not there (OSError) or that fails
        (RuntimeError) leaves the port on the numpy fallback, with a
        warning; the build directory is the test's own, so no cached
        library hides the failure."""
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++")
                           if cxx == "missing" else "false")
        monkeypatch.setattr(tnative.LIBRARY, "build_dir", tmp_path)
        monkeypatch.setattr(tnative.LIBRARY, "_lib", None)
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_tried", False)
        with caplog.at_level("WARNING", logger=tnative.__name__):
            assert not tnative.available()
        assert "numpy fallback" in caplog.text
        assert not list(tmp_path.glob("*.so"))
        img = RNG.integers(0, 256, (12, 10, 3), dtype=np.uint8)
        data = jppm.encode_ppm(img)
        assert tnative.encode_ppm(img) == data
        assert np.array_equal(tnative.decode_ppm_gray(data),
                              tppm.rgb_to_gray_u8(img))
