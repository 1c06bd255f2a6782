"""The accuracy of E1's and E2's split-bf16 operands (ops/csrc/iic.cu),
emulated on the CPU in float64, before any card runs the kernels.

E2 runs its products on bf16 tensor cores with every f32 operand split into
bf16 pieces, x ~= x0 + x1 (+ x2), each piece the rounding of what the earlier
ones left; a product takes the pairs of pieces (i, j) with i + j < pieces.
bf16 features are exact. Here the same roundings are applied to E2's formulas
in float64 and the results held to the card tests' tolerances
(tests/test_torch_cuda.py: feature gradients 2^-6 of the largest value in
bf16 and 1e-5 in f32, dW and db 1e-4) against E2's plain version run in
float64, at the card tests' ragged shapes on random and on the dense loss's
own cotangents. A second test shows why the cotangent is centred first.
E1's scheme (W_s in three pieces on bf16 features, the FP32 cores' exact
projection on f32 features; p in two pieces) is held to the card tests' 1e-5
of the largest raw joint against E1's plain version in f32, and the dense
loss through it to chip_smoke.py's IIC_LOSS_RTOL; a last test shows that p
in one piece misses the 1e-5.

    PYTHONPATH=. python tests/test_torch_split_bf16.py

prints every case's errors (max |err| / max |ref| of df1, df2, dW, db; of
E1's raw joints and the relative error of its loss).
"""
import numpy as np
import pytest
import torch

from contrastyou_tpu_torch.losses.discrete_mi import iid_loss_from_raw_joints
from contrastyou_tpu_torch.ops.iic import iic_joints_bwd_plain, iic_joints_plain

torch.set_num_threads(1)

K = 20
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
DK_TOL = 1e-4
#: E1's raw joints against its plain version, in units of the largest raw
#: joint (tests/test_torch_cuda.py), and the dense loss through them
#: (chip_smoke.py)
RAW_TOL = 1e-5
IIC_LOSS_RTOL = 1e-3



def e2_scheme(dtype, padding: int, center: bool = True) -> dict:
    """Pieces per operand as the kernel takes them (0: not rounded): f
    (features, dW's A operand), w (the projection's weights; f32 features
    project on the FP32 cores), p (softmax maps), j (cotangent: a third piece
    at padding 0), dz (df's A and dW's B operand), wdf (df's B operand);
    ``center``: the cotangent centred per view (minus its mean over j for
    dp2, over i for dp1)."""
    j = 3 if padding == 0 else 2
    if dtype == torch.bfloat16:
        return dict(f=0, w=2, p=2, j=j, dz=2, wdf=2, center=center)
    return dict(f=3, w=0, p=3, j=j, dz=3, wdf=3, center=center)


#: (B, H, W, C, S, padding, features): the card tests' ragged images
CASES = [(2, 17, 33, 32, 5, 1, torch.bfloat16), (2, 17, 33, 16, 5, 2, torch.bfloat16),
         (2, 17, 33, 32, 5, 0, torch.bfloat16), (2, 17, 33, 8, 8, 0, torch.bfloat16),
         (2, 17, 33, 8, 3, 0, torch.float32), (2, 17, 33, 32, 2, 2, torch.float32),
         (2, 17, 33, 32, 8, 1, torch.float32), (2, 17, 33, 16, 8, 0, torch.float32)]


def pieces(x: torch.Tensor, n: int):
    """x as n bf16 pieces (float64), or [x] itself for n = 0."""
    if n == 0:
        return [x.double()]
    x, out = x.float(), []
    for _ in range(n):
        h = x.to(torch.bfloat16).float()
        out.append(h.double())
        x = x - h
    return out


def mm(eq: str, a: torch.Tensor, b: torch.Tensor, na: int, nb: int) -> torch.Tensor:
    """The einsum ``eq`` of a and b as the kernel's split products form it
    (float64 sums of the products of pieces, rounded to f32 at the end)."""
    pa, pb = pieces(a, na), pieces(b, nb)
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(pa) for j, y in enumerate(pb)
               if i + j < max(len(pa), len(pb))).float()


def e2_split(f1, f2, w, b, jbar, S: int, P: int, sc: dict):
    """E2's formulas with the operand roundings of scheme ``sc``."""
    B, H, W, C = f1.shape
    td = 2 * P + 1

    def probs(f):
        z = mm("bhwc,ck->bhwk", f, w, sc["f"] if sc["w"] else 0, sc["w"]) + b
        s = torch.softmax(z.reshape(B, H, W, S, K), -1)
        return s, sum(pieces(s, sc["p"])).float()

    (s1, p1), (s2, p2) = probs(f1), probs(f2)
    j2 = j1 = jbar
    if sc["center"]:
        j2, j1 = jbar - jbar.mean(-1, keepdim=True), jbar - jbar.mean(-2, keepdim=True)
    pad = lambda p: torch.nn.functional.pad(p, (0, 0, 0, 0, P, P, P, P))
    p1, p2 = pad(p1), pad(p2)
    dp2 = sum(mm("bhwsi,sij->bhwsj", p1[:, ty:ty + H, tx:tx + W], j2[:, ty, tx], sc["p"], sc["j"])
              for ty in range(td) for tx in range(td))
    dp1 = sum(mm("bhwsj,sij->bhwsi", p2[:, 2 * P - ty:2 * P - ty + H, 2 * P - tx:2 * P - tx + W],
                 j1[:, ty, tx], sc["p"], sc["j"]) for ty in range(td) for tx in range(td))
    vjp = lambda dp, s: (s * (dp - (dp * s).sum(-1, keepdim=True))).reshape(B, H, W, S * K)
    dz1, dz2 = vjp(dp1, s1), vjp(dp2, s2)
    wt = w.T.contiguous()
    df1, df2 = (mm("bhwk,kc->bhwc", dz, wt, sc["dz"], sc["wdf"]).to(f1.dtype) for dz in (dz1, dz2))
    dw = sum(mm("bhwc,bhwk->ck", f, dz, sc["f"], sc["dz"]).double()
             for f, dz in ((f1, dz1), (f2, dz2))).float()
    return df1, df2, dw, dz1.sum((0, 1, 2)) + dz2.sum((0, 1, 2))


def e1_scheme(dtype) -> dict:
    """E1's pieces per operand (0: not rounded): f (features, the
    projection's A operand), w (its B operand; f32 features project on the
    FP32 cores), p (softmax maps, both operands of the joints)."""
    if dtype == torch.bfloat16:
        return dict(f=0, w=3, p=2)
    return dict(f=0, w=0, p=2)


def e1_split(f1, f2, w, b, S: int, P: int, sc: dict) -> torch.Tensor:
    """E1's raw joints [S, Td, Td, K, K] with the operand roundings of
    scheme ``sc``."""
    B, H, W, C = f1.shape
    td = 2 * P + 1

    def probs(f):
        z = mm("bhwc,ck->bhwk", f, w, sc["f"], sc["w"]) + b
        return torch.softmax(z.reshape(B, H, W, S, K), -1)

    p1 = torch.nn.functional.pad(probs(f1), (0, 0, 0, 0, P, P, P, P))
    p2 = probs(f2)
    return torch.stack([torch.stack([
        mm("bhwsi,bhwsj->sij", p1[:, ty:ty + H, tx:tx + W], p2, sc["p"], sc["p"])
        for tx in range(td)], 1) for ty in range(td)], 1)


#: (B, H, W, C, S, padding, features): the E1 card tests' ragged images,
#: every padding, width and dtype, S = 1 and S * K = 160
E1_CASES = [(2, 20, 36, 32, 5, 1, torch.bfloat16), (2, 17, 33, 16, 8, 1, torch.bfloat16),
            (2, 17, 33, 8, 1, 0, torch.bfloat16), (2, 20, 36, 32, 5, 0, torch.bfloat16),
            (2, 20, 36, 16, 5, 2, torch.bfloat16), (1, 17, 33, 32, 8, 2, torch.bfloat16),
            (2, 20, 36, 8, 3, 0, torch.float32), (2, 17, 33, 16, 1, 1, torch.float32),
            (2, 20, 36, 32, 8, 1, torch.float32), (2, 17, 33, 32, 2, 2, torch.float32),
            (1, 20, 36, 8, 5, 2, torch.float32), (2, 17, 33, 32, 5, 0, torch.float32)]


def _e1_errors(B, H, W, C, S, P, dtype, sc):
    """(max |err| / max |ref| of the raw joints, relative error of the summed
    dense loss) of scheme ``sc`` against E1's plain version in f32."""
    f1, f2, w, b, _ = _inputs(B, H, W, C, S, P, dtype, "randn")
    got = e1_split(f1, f2, w, b, S, P, sc).double()
    ref = iic_joints_plain(f1, f2, w, b, num_subheads=S, num_clusters=K, padding=P).double()
    raw = float((got - ref).abs().max() / ref.abs().max())
    loss = [float(iid_loss_from_raw_joints(r, padding=P, count=B * H * W).sum()) for r in (got, ref)]
    return raw, abs(loss[0] - loss[1]) / abs(loss[1])


@pytest.mark.parametrize("B,H,W,C,S,P,dtype", E1_CASES)
def test_e1_operand_split_keeps_the_card_tolerances(B, H, W, C, S, P, dtype):
    """E1's scheme keeps the raw joints within RAW_TOL and the dense loss
    within IIC_LOSS_RTOL of the f32 plain version."""
    raw, loss = _e1_errors(B, H, W, C, S, P, dtype, e1_scheme(dtype))
    assert raw <= RAW_TOL, f"raw {raw:.2e} > {RAW_TOL}"
    assert loss <= IIC_LOSS_RTOL, f"loss {loss:.2e} > {IIC_LOSS_RTOL}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_e1_needs_p_in_two_pieces(dtype):
    """p in one bf16 piece (one product a pair) takes the raw joints beyond
    RAW_TOL; the kernel's two pieces keep them within."""
    case = (2, 20, 36, 32, 5, 1, dtype)
    assert _e1_errors(*case, dict(e1_scheme(dtype), p=1))[0] > RAW_TOL
    assert _e1_errors(*case, e1_scheme(dtype))[0] <= RAW_TOL


def _inputs(B, H, W, C, S, P, dtype, cot, seed=0):
    rng = np.random.default_rng(seed)
    f1, f2 = (torch.from_numpy(rng.standard_normal((B, H, W, C))).float().to(dtype)
              for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((C, S * K)) * 0.3).float()
    b = torch.from_numpy(rng.standard_normal(S * K) * 0.1).float()
    if cot == "randn":
        return f1, f2, w, b, torch.from_numpy(rng.standard_normal((S, 2 * P + 1, 2 * P + 1, K, K))).float()
    raw = iic_joints_plain(f1, f2, w, b, num_subheads=S, num_clusters=K, padding=P).requires_grad_()
    (0.05 * iid_loss_from_raw_joints(raw, padding=P, count=B * H * W).sum()).backward()
    return f1, f2, w, b, raw.grad


def _errors(f1, f2, w, b, jbar, S, P, sc):
    """max |err| / max |ref| of df1, df2, dW, db against the plain version in
    float64 (feature gradients compared in the features' dtype)."""
    got = e2_split(f1, f2, w, b, jbar, S, P, sc)
    ref = iic_joints_bwd_plain(f1.double(), f2.double(), w.double(), b.double(), jbar.double(),
                               num_subheads=S, num_clusters=K, padding=P)
    out = []
    for i, (a, r) in enumerate(zip(got, ref)):
        if i < 2:
            r = r.to(f1.dtype)
        a, r = a.double(), r.double()
        out.append(float((a - r).abs().max() / r.abs().max()))
    return out


@pytest.mark.parametrize("cot", ["randn", "loss"])
@pytest.mark.parametrize("B,H,W,C,S,P,dtype", CASES)
def test_e2_operand_split_keeps_the_card_tolerances(B, H, W, C, S, P, dtype, cot):
    """E2's scheme (two pieces for bf16 features, three for f32, the
    cotangent centred) stays within the card tests' tolerances."""
    args = _inputs(B, H, W, C, S, P, dtype, cot)
    errs = _errors(*args, S, P, e2_scheme(dtype, P))
    for name, e, tol in zip(("df1", "df2", "dW", "db"), errs, (TOL[dtype], TOL[dtype], DK_TOL, DK_TOL)):
        assert e <= tol, f"{name}: {e:.2e} > {tol}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_padding_0_loss_needs_more_than_a_two_piece_cotangent(dtype):
    """At padding 0 the loss divides the joint by the pixel count, so its
    cotangent carries a large constant that the softmax VJP removes, and db
    sums terms that cancel over every pixel. A cotangent split plainly in two
    pieces takes db beyond DK_TOL; the kernel's scheme keeps it within."""
    args = _inputs(2, 17, 33, 8, 8, 0, dtype, "loss")
    assert _errors(*args, 8, 0, dict(e2_scheme(dtype, 0), j=2, center=False))[3] > DK_TOL
    assert _errors(*args, 8, 0, e2_scheme(dtype, 0))[3] <= DK_TOL


if __name__ == "__main__":
    print("E1: max |err| / max |ref| of the raw joints, relative error of the loss, against "
          "the plain version in f32")
    for case in E1_CASES:
        dtype = case[-1]
        line = f"{case[:4]} {str(dtype)[6:]} S={case[4]} pad={case[5]}"
        schemes = [("E1", e1_scheme(dtype)), ("p in 1", dict(e1_scheme(dtype), p=1))]
        if dtype == torch.bfloat16:
            schemes.append(("W in 2", dict(e1_scheme(dtype), w=2)))
        for name, sc in schemes:
            line += f" | {name} " + " ".join(f"{e:.1e}" for e in _e1_errors(*case, sc))
        print(line, flush=True)
    print("E2: max |err| / max |ref| of df1 df2 dW db against the plain version in float64")
    for B, H, W, C, S, P, dtype in CASES:
        for cot in ("randn", "loss"):
            args = _inputs(B, H, W, C, S, P, dtype, cot)
            line = f"{(B, H, W, C)} {str(dtype)[6:]} S={S} pad={P} {cot:5s}"
            for name, sc in (("E2", e2_scheme(dtype, P)),
                             ("uncentred", e2_scheme(dtype, P, center=False)),
                             ("cotangent in 2", dict(e2_scheme(dtype, P), j=2)),
                             ("in 2 uncentred", dict(e2_scheme(dtype, P, center=False), j=2))):
                line += f" | {name} " + " ".join(f"{e:.1e}" for e in _errors(*args, S, P, sc))
            print(line, flush=True)
