"""Grid-batched encoding: vmapped distance axis must be byte-identical to
per-point encodes (same compiled program, same streams)."""

from jxl_jax.codec.config import CodecConfig, Strategy
from jxl_jax.codec.decode import decode_bytes
from jxl_jax.codec.encode import encode_image, encode_image_grid
from jxl_jax.metrics import calculate_psnr
from tests.conftest import make_test_image


def test_grid_matches_single_encodes():
    img = make_test_image(64, 80, seed=3)
    ds = [0.5, 1.0, 4.0]
    datas = encode_image_grid(img, CodecConfig(effort=5), ds)
    assert len(datas) == 3
    for d, data in zip(ds, datas):
        single = encode_image(img, CodecConfig(distance=d, effort=5))
        assert data == single, d


def test_grid_with_strategy_and_decode():
    img = make_test_image(48, 48, seed=6)
    datas = encode_image_grid(
        img,
        CodecConfig(effort=7, strategy=Strategy.COMBINED),
        [1.0, 8.0],
        orig_name="g.png",
    )
    sizes = [len(d) for d in datas]
    assert sizes[0] > sizes[1]  # rate falls with distance
    for data in datas:
        out = decode_bytes(data)
        assert calculate_psnr(img, out) > 28.0


def test_grid_floors_d_zero():
    img = make_test_image(32, 32, seed=1)
    datas = encode_image_grid(img, CodecConfig(effort=4), [0.0])
    out = decode_bytes(datas[0])
    assert calculate_psnr(img, out) > 40.0
