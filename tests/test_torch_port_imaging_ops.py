"""The port's NIfTI IO, native host prep and image ops against the JAX
package's, on the same numpy inputs (CPU).

Tolerances:
- NIfTI reads: equal (both widen the stored values to float32 and scale
  in float32 the same way);
- the port's native prep (``csrc/pd_io.cpp``) against the JAX package's
  (``native/pd_io.cpp``, the same code): bit for bit in float32 and in
  float16; the float16 output equals ``astype(np.float16)`` of the
  float32 one bit for bit;
- native prep against the numpy mirrors: rtol 2e-5, atol 2e-6, the JAX
  package's own bound (``tests/test_native_io.py``): the mirrors normalize
  in float64 and round once, the native prep in float32, up to a few ulp;
- the port's numpy mirrors against the JAX package's: bit for bit;
- image ops: integer indices exactly; floats within 1e-6 absolute of the
  data's scale (``resize3d`` 4e-6 against JAX, 1e-6 against float64 on
  the exact grid: see its test; ``affine2d_batch`` 1e-5: its coordinates
  pass through cos/sin and a 2x2 product, which XLA and torch round
  differently).
"""
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pd_fusion.imaging import native as JN
from pd_fusion.imaging import pipeline as JP
from pd_fusion.imaging.nifti import read_nifti as jax_read_nifti
from pd_fusion.imaging.nifti import write_nifti as jax_write_nifti
from pd_fusion.ops import image as JI
from pd_fusion_torch.imaging import native as TN
from pd_fusion_torch.imaging import pipeline as TP
from pd_fusion_torch.imaging.nifti import read_nifti, write_nifti
from pd_fusion_torch.ops import image as TI
from test_torch_port_jax_draws import one_cpu_thread


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("PD_FUSION_TORCH_DEVICE", "cpu")
    monkeypatch.delenv(TN.NO_NATIVE_ENV, raising=False)
    with one_cpu_thread():
        yield


def _volumes():
    rng = np.random.RandomState(5)
    return {
        "f32": (rng.rand(18, 20, 16).astype(np.float32), 1.0, 0.0),
        "i16_scaled": ((rng.rand(33, 29, 31) * 1200 - 100).astype(np.int16), 0.5, 3.0),
        "i16": ((rng.rand(33, 29, 31) * 1200 - 100).astype(np.int16), 1.0, 0.0),
        "u16": ((rng.rand(21, 19, 23) * 2400).astype(np.uint16), 1.0, 0.0),
        "sparse": (np.where(rng.rand(18, 20, 16) < 0.02, rng.rand(18, 20, 16),
                            0.0).astype(np.float32), 1.0, 0.0),
        "all_negative": ((-1.0 - rng.rand(18, 20, 16)).astype(np.float32), 1.0, 0.0),
        "constant": (np.full((18, 20, 16), 0.73, np.float32), 1.0, 0.0),
    }


VOLUMES = list(_volumes())
EXTS = [".nii.gz", ".nii"]
PLANS = [((16, 16, 16), [2], [4]), ((16, 16, 16), [0, 1, 2], [3, 4, 5]),
         ((14, 16, 12), [1], [6])]


# ---------------------------------------------------------------------------
# NIfTI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("name", VOLUMES)
def test_nifti_round_trip_and_jax_reader_on_the_ports_files(tmp_path, name, ext):
    vol, slope, inter = _volumes()[name]
    p = tmp_path / f"v{ext}"
    write_nifti(p, vol, scl_slope=slope, scl_inter=inter)
    assert (p.read_bytes()[:2] == b"\x1f\x8b") == (ext == ".nii.gz")
    got = read_nifti(p)
    want = vol.astype(np.float32) * np.float32(slope) + np.float32(inter) if slope != 1.0 else (
        vol.astype(np.float32))
    assert got.dtype == np.float32 and got.shape == vol.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_read_nifti(p), got)
    np.testing.assert_array_equal(TN.read_nifti_native(p), got)


@pytest.mark.parametrize("ext", EXTS)
def test_port_reads_the_jax_writers_files(tmp_path, ext):
    vol = (np.random.RandomState(1).rand(7, 9, 8) * 500).astype(np.int16)
    p = tmp_path / f"j{ext}"
    jax_write_nifti(p, vol)
    np.testing.assert_array_equal(read_nifti(p), jax_read_nifti(p))


def test_nifti_scaling_header_fields_are_what_the_jax_reader_applies(tmp_path):
    """A scaled file written by the JAX writer and patched by hand, as the
    JAX package's own int16 test does, reads the same in both."""
    vol = (np.random.RandomState(11).rand(9, 8, 7) * 1200 - 100).astype(np.int16)
    p = tmp_path / "patched.nii.gz"
    jax_write_nifti(p, vol)
    raw = bytearray(gzip.decompress(p.read_bytes()))
    import struct

    struct.pack_into("<f", raw, 112, 2.5)
    struct.pack_into("<f", raw, 116, -7.0)
    p.write_bytes(gzip.compress(bytes(raw)))
    np.testing.assert_array_equal(read_nifti(p), jax_read_nifti(p))
    np.testing.assert_array_equal(TN.read_nifti_native(p), read_nifti(p))


# ---------------------------------------------------------------------------
# the native prep
# ---------------------------------------------------------------------------


def _write(tmp_path, name, ext):
    vol, slope, inter = _volumes()[name]
    p = tmp_path / f"{name}{ext}"
    write_nifti(p, vol, scl_slope=slope, scl_inter=inter)
    return p


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("name", VOLUMES)
def test_native_prep_matches_jax_native_and_numpy_mirrors(tmp_path, name, ext):
    p = _write(tmp_path, name, ext)
    for shape, axes, counts in PLANS:
        got = TN.prep_slices_native(p, shape, axes, counts)
        assert got.dtype == np.float32 and got.shape[0] == sum(counts)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      JN.prep_slices_native(p, shape, axes, counts).view(np.uint32))
        half = TN.prep_slices_native(p, shape, axes, counts, out_dtype=np.float16)
        np.testing.assert_array_equal(half.view(np.uint16), got.astype(np.float16).view(np.uint16))
        np.testing.assert_array_equal(
            half.view(np.uint16),
            JN.prep_slices_native(p, shape, axes, counts, out_dtype=np.float16).view(np.uint16))
        normed = JP.normalize_volume_host(JP.load_volume(p, shape))
        mirror = np.concatenate([JP.select_slices_host(normed, a, c) for a, c in zip(axes, counts)])
        np.testing.assert_allclose(got, mirror, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("name", VOLUMES)
def test_numpy_mirrors_match_the_jax_packages_bit_for_bit(tmp_path, name):
    p = _write(tmp_path, name, ".nii.gz")
    vol = TN.read_resize_nifti_native(p, (16, 16, 16))
    np.testing.assert_array_equal(vol, JN.read_resize_nifti_native(p, (16, 16, 16)))
    normed = TP.normalize_volume_host(vol)
    np.testing.assert_array_equal(normed, JP.normalize_volume_host(vol))
    for axis in range(3):
        np.testing.assert_array_equal(TP.select_slices_host(normed, axis, 5),
                                      JP.select_slices_host(normed, axis, 5))


@pytest.mark.parametrize("wire", [np.float32, np.float16], ids=["f32", "f16"])
def test_slices_loader_without_native_matches_native(tmp_path, monkeypatch, wire):
    """PD_FUSION_NO_NATIVE=1 runs the numpy mirrors (read + torch resize +
    normalize + gather), explicitly; the result agrees with the native prep."""
    p = _write(tmp_path, "i16_scaled", ".nii.gz")
    shape, axes, counts = PLANS[1]
    native_out = TP.make_slices_loader(shape, axes, counts, out_dtype=wire)(p)
    monkeypatch.setenv(TN.NO_NATIVE_ENV, "1")
    assert TN.disabled()
    mirror_out = TP.make_slices_loader(shape, axes, counts, out_dtype=wire)(p)
    assert native_out.dtype == mirror_out.dtype == wire
    tol = (2e-5, 2e-6) if wire == np.float32 else (1e-3, 1e-3)
    np.testing.assert_allclose(native_out.astype(np.float32), mirror_out.astype(np.float32),
                               rtol=tol[0], atol=tol[1])


def test_native_failures_raise(tmp_path):
    with pytest.raises(TN.NativeError, match="error 1"):
        TN.prep_slices_native(tmp_path / "missing.nii.gz", (8, 8, 8), [2], [3])
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"\x00" * 400)
    with pytest.raises(TN.NativeError, match="error 3"):
        TN.read_nifti_native(bad)
    with pytest.raises(ValueError, match="cubic"):
        TN.prep_slices_native(bad, (8, 8, 9), [0, 1], [2, 2])
    assert TN.build_info()["inflate"] in ("libdeflate", "zlib")


def test_native_build_failure_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """A source that does not compile raises NativeError naming every
    inflate variant tried; nothing falls back to the numpy mirrors."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "HOST_BUILD_DIR", tmp_path / "build")
    with pytest.raises(TN.NativeError, match="every inflate library"):
        TN.build_library(broken)


# ---------------------------------------------------------------------------
# ops/image
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _resize3d_f64(vol, target):
    """Align-corners trilinear resize in float64 on the exact grid."""
    out = vol.astype(np.float64)
    for axis, n_out in enumerate(target):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        if n_in == 1:
            out = np.repeat(out, n_out, axis=axis)
            continue
        pos = np.linspace(0.0, n_in - 1.0, n_out)
        i0 = np.clip(np.floor(pos).astype(int), 0, n_in - 2)
        t = (pos - i0).reshape([-1 if a == axis else 1 for a in range(3)])
        out = np.take(out, i0, axis) * (1 - t) + np.take(out, i0 + 1, axis) * t
    return out


def test_resize3d_matches_jax():
    """Within 1e-6 (relative to the data's scale) of float64 arithmetic on
    the exact grid. Against the JAX function within 4e-6: XLA's CPU
    float32 division puts about a quarter of ``jnp.linspace``'s grid
    points one ulp off the correctly rounded value (the port's grid is
    ``jnp.linspace``'s formula, correctly rounded), which moves a sample by
    up to ulp(position) times the step between neighbouring voxels."""
    rng = np.random.RandomState(1)
    for vol, target in ((rng.rand(20, 24, 18).astype(np.float32), (12, 14, 10)),
                        (rng.rand(7, 1, 9).astype(np.float32), (16, 5, 16)),
                        ((rng.rand(9, 10, 11) * 900).astype(np.int16), (16, 16, 16))):
        scale = max(1.0, float(np.abs(vol).max()))
        got = TI.resize3d(_t(vol), target).numpy()
        assert got.dtype == np.float32 and got.shape == target
        np.testing.assert_allclose(got, _resize3d_f64(vol, target), rtol=0, atol=1e-6 * scale)
        want = np.asarray(JI.resize3d(jnp.asarray(vol), target))
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6 * scale)


def test_native_resize_matches_jax_native_and_the_port_function(tmp_path):
    rng = np.random.RandomState(8)
    vol = rng.rand(20, 24, 18).astype(np.float32)
    got = TN.resize3d_native(vol, (12, 14, 10), n_threads=3)
    np.testing.assert_array_equal(got, JN.resize3d_native(vol, (12, 14, 10), n_threads=3))
    np.testing.assert_allclose(got, TI.resize3d(_t(vol), (12, 14, 10)).numpy(), atol=2e-6)
    p = tmp_path / "v.nii.gz"
    write_nifti(p, vol)
    np.testing.assert_array_equal(TN.read_resize_nifti_native(p, (8, 10, 12)),
                                  JN.read_resize_nifti_native(p, (8, 10, 12)))


def test_resize2d_halfpix_matches_jax_and_interpolate():
    rng = np.random.RandomState(2)
    imgs = rng.rand(3, 17, 13).astype(np.float32)
    for size in ((32, 32), (8, 21), (17, 13)):
        want = np.asarray(JI.resize2d_halfpix(jnp.asarray(imgs), size))
        got = TI.resize2d_halfpix(_t(imgs), size).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        ref = F.interpolate(_t(imgs)[:, None], size=size, mode="bilinear",
                            align_corners=False)[:, 0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_masked_percentile_rank_arithmetic_is_exact():
    """On values equal to their index, numpy's 'linear' percentile is its
    float64 virtual index ``(count - 1) * q / 100``: the port's integer rank
    arithmetic gives it at counts far beyond float32's exact integers, for
    every q the pipeline uses, and agrees with the JAX function."""
    for count in (1, 2, 3, 7, 100, 101, 12345, 160**3, 2**24 + 3):
        vals = torch.arange(count, dtype=torch.float64)
        for q in (1, 10, 50, 90, 99):
            got = TI._masked_percentile(vals, torch.tensor(count, dtype=torch.int32), q)
            assert float(got) == pytest.approx((count - 1) * q / 100.0, abs=1e-6), (count, q)
    rng = np.random.RandomState(3)
    vals = np.sort(rng.rand(5000).astype(np.float32))
    for count in (1, 2, 57, 4999, 5000):
        for q in (1, 99):
            got = TI._masked_percentile(_t(vals), torch.tensor(count, dtype=torch.int32), q)
            want = JI._masked_percentile(jnp.asarray(vals), jnp.int32(count), q)
            np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
            np.testing.assert_allclose(float(got), np.percentile(vals[:count], q), atol=1e-6)


@pytest.mark.parametrize("name", ["f32", "sparse", "all_negative", "constant", "i16_scaled"])
def test_percentile_normalize_matches_jax(name):
    vol, slope, inter = _volumes()[name]
    vol = vol.astype(np.float32) * np.float32(slope) + np.float32(inter)
    want = np.asarray(JI.percentile_normalize(jnp.asarray(vol)))
    got = TI.percentile_normalize(_t(vol)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_slice_indices_and_take_slices_match_jax_exactly():
    rng = np.random.RandomState(4)
    cases = []
    for lo, d, n_axis, count in ((0, 46, 47, 24), (1, 23, 30, 24), (0, 92, 96, 24),
                                 (5, 3, 12, 8), (0, 0, 4, 3), (2, 40, 50, 1)):
        vol = np.zeros((n_axis, 6, 5), np.float32)
        vol[lo: lo + d + 1] = 1.0 + rng.rand(d + 1, 6, 5)
        cases.append((vol, count))
    cases.append((np.zeros((9, 6, 5), np.float32), 4))  # no positive voxel
    for vol, count in cases:
        for axis in range(3):
            v = np.moveaxis(vol, 0, axis).copy()
            want = np.asarray(JI.select_slice_indices(jnp.asarray(v), axis, count))
            got = TI.select_slice_indices(_t(v), axis, count)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(TI.take_slices(_t(v), axis, count).numpy(),
                                          np.asarray(JI.take_slices(jnp.asarray(v), axis, count)))


def test_affine2d_batch_matches_jax_with_no_blend_at_the_border():
    rng = np.random.RandomState(6)
    slices = rng.rand(5, 16, 20).astype(np.float32)
    for angle, shift in ((0.0, (0.0, 0.0)), (7.5, (1.3, -2.2)), (-30.0, (0.0, 4.0)),
                         (3.0, (-0.8, 0.8))):
        want = np.asarray(JI.affine2d_batch(jnp.asarray(slices), jnp.float32(angle),
                                            jnp.asarray(shift, jnp.float32)))
        got = TI.affine2d_batch(_t(slices), angle, np.asarray(shift, np.float32)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a shift by half a pixel puts the last row's source at size - 0.5: out
    # of [0, size - 1], so 0, not a blend with the padding
    got = TI.affine2d_batch(_t(slices), 0.0, np.asarray([0.5, 0.0], np.float32)).numpy()
    assert (got[:, -1] == 0).all() and (got[:, :-1] != 0).any()
    # many subjects at once equal the single-subject function
    angles = np.asarray([4.0, -9.0], np.float32)
    shifts = np.asarray([[1.0, 0.5], [-2.0, 0.0]], np.float32)
    two = np.stack([slices, slices[::-1].copy()])
    batched = TI.affine2d_subjects(_t(two), _t(angles), _t(shifts)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(batched[b],
                                      TI.affine2d_batch(_t(two[b]), angles[b], shifts[b]).numpy())


def test_imagenet_batch_and_zscore_match_jax():
    rng = np.random.RandomState(7)
    slices = rng.rand(4, 16, 12).astype(np.float32)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    want = np.asarray(JI.slices_to_imagenet_batch(jnp.asarray(slices), 32, jnp.asarray(mean),
                                                  jnp.asarray(std)))
    got = TI.slices_to_imagenet_batch(_t(slices), 32, _t(mean), _t(std)).numpy()
    assert got.shape == want.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    vol = rng.rand(9, 8, 7).astype(np.float32) * 5
    np.testing.assert_allclose(TI.zscore_volume(_t(vol)).numpy(),
                               np.asarray(JI.zscore_volume(jnp.asarray(vol))), rtol=0, atol=1e-6)
