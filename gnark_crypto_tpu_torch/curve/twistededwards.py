"""Twisted Edwards companion curves (a*x^2 + y^2 = 1 + d*x^2*y^2).

Counterpart of ``gnark_crypto_tpu/curve/twistededwards.py`` (reference
``ecc/<curve>/twistededwards``): the companion curve lives over the parent
curve's *scalar* field Fr (point.go:18-28). Batched extended (X:Y:T:Z)
coordinates with the unified Hisil et al. formulas, complete for the gnark
curves (a = -1, d non-square; bandersnatch a = -5), so no masked special
cases beyond identity handling (identity = (0, 1), which the formulas
cover).

Points are NamedTuples of ``int32[..., W]`` Montgomery word tensors
(``field/mont.py``). The group law is composed of field ops, as in the
reference (no TPU kernel computes it): on the card each product call is a
``mont_mul`` launch over the batch, on the CPU its plain version. Every op
runs on the device of its points; the constructors take the curve's
device (:func:`ted_curve`). The scalar ladders read their bits on the host
and skip the add of a step where no lane has its bit set (the masked add
would keep the accumulator: the same points).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from gnark_crypto_tpu_torch.curve.glv import split_scalar
from gnark_crypto_tpu_torch.curve.jacobian import int_bits
from gnark_crypto_tpu_torch.field.api import FieldEngine, for_spec
from gnark_crypto_tpu_torch.field.mont import DEFAULT_DEVICE
from gnark_crypto_tpu_torch.specs import field as fs
from gnark_crypto_tpu_torch.specs.curve import _lattice_2d
from gnark_crypto_tpu_torch.specs.field import FieldSpec


@dataclasses.dataclass(frozen=True)
class TwistedEdwardsSpec:
    name: str
    base: FieldSpec      # coordinate field (= parent curve's Fr)
    a: int
    d: int
    cofactor: int
    order: int           # order of the prime subgroup
    gx: int
    gy: int
    # GLV endomorphism (bandersnatch only: phi = sqrt(-2) in End(E),
    # phi(P) = [glv_lambda]P; bandersnatch/curve.go:68-71)
    endo: tuple[int, int] | None = None
    glv_lambda: int | None = None


_REGISTRY: dict[str, TwistedEdwardsSpec] = {}


def register(s: TwistedEdwardsSpec) -> TwistedEdwardsSpec:
    _REGISTRY[s.name] = s
    return s


def get_ted(name: str) -> TwistedEdwardsSpec:
    return _REGISTRY[name]


# constants from internal/generator/config/<curve>.go TwistedEdwardsCurve
BN254_TED = register(TwistedEdwardsSpec(
    name="bn254",
    base=fs.BN254_FR,
    a=-1,
    d=12181644023421730124874158521699555681764249180949974110617291017600649128846,
    cofactor=8,
    order=2736030358979909402780800718157159386076813972158567259200215660948447373041,
    gx=9671717474070082183213120605117400219616337014328744928644933853176787189663,
    gy=16950150798460657717958625567821834550301663161624707787222815936182638968203,
))

BLS12_377_TED = register(TwistedEdwardsSpec(
    name="bls12_377",
    base=fs.BLS12_377_FR, a=-1, d=3021, cofactor=4,
    order=2111115437357092606062206234695386632838870926408408195193685246394721360383,
    gx=717051916204163000937139483451426116831771857428389560441264442629694842243,
    gy=882565546457454111605105352482086902132191855952243170543452705048019814192,
))

BLS12_381_TED = register(TwistedEdwardsSpec(
    name="bls12_381",
    base=fs.BLS12_381_FR, a=-1,
    d=19257038036680949359750312669786877991949435402254120286184196891950884077233,
    cofactor=8,
    order=6554484396890773809930967563523245729705921265872317281365359162392183254199,
    gx=23426137002068529236790192115758361610982344002369094106619281483467893291614,
    gy=39325435222430376843701388596190331198052476467368316772266670064146548432123,
))

BANDERSNATCH = register(TwistedEdwardsSpec(
    name="bandersnatch",
    base=fs.BLS12_381_FR, a=-5,
    d=45022363124591815672509500913686876175488063829319466900776701791074614335719,
    cofactor=4,
    order=13108968793781547619861935127046491459309155893440570251786403306729687672801,
    gx=18886178867200960497001835917649091219057080094937609519140440539760939937304,
    gy=19188667384257783945677642223292697773471335439753913231509108946878080696678,
    endo=(37446463827641770816307242315180085052603635617490163568005256780843403514036,
          49199877423542878313146170939139662862850515542392585932876811575731455068989),
    glv_lambda=8913659658109529928382530854484400854125314752504019737736543920008458395397,
))

BLS24_315_TED = register(TwistedEdwardsSpec(
    name="bls24_315",
    base=fs.BLS24_315_FR, a=-1,
    d=8771873785799030510227956919069912715983412030268481769609515223557738569779,
    cofactor=8,
    order=1437753473921907580703509300571927811987591765799164617677716990775193563777,
    gx=750878639751052675245442739791837325424717022593512121860796337974109802674,
    gy=1210739767513185331118744674165833946943116652645479549122735386298364723201,
))

BLS24_317_TED = register(TwistedEdwardsSpec(
    name="bls24_317",
    base=fs.BLS24_317_FR, a=-1,
    d=20748505950524021841644589704740731932416084248011369709738936344973878925081,
    cofactor=8,
    order=3858698654557105525567273719690987823069521430163883173133245580997415449969,
    gx=4348505656527095883506785370890963704100065639426869666063106978260788240233,
    gy=1929349327278552762783636859845493911537170411830425720219700276810167091201,
))

BW6_761_TED = register(TwistedEdwardsSpec(
    name="bw6_761",
    base=fs.BW6_761_FR, a=-1, d=79743, cofactor=8,
    order=32333053251621136751331591711861691692049189094364332567435817881934511297123972799646723302813083835942624121493,
    gx=109887223397525145051017418760180386187632078445902299543670312117371514695798874370143656894667315818446285582389,
    gy=31146823455109675839494591101665406662142618451815824757336761504421066243585705807124836638254810186490790034654,
))

BW6_633_TED = register(TwistedEdwardsSpec(
    name="bw6_633",
    base=fs.BW6_633_FR, a=-1,
    d=37248940285811842784899494310834635440994424264352085037441815381151934266434102922992043546621,
    cofactor=8,
    order=4963142838689179791878211236301121218116687802119716497817028544854034649070444389864454748079,
    gx=37635937024655419978837220647164498012335808680404874556501960268316961933409049243153117555100,
    gy=23823085625708063001015413934245381846960101450148849601038571303382730455875805408244170280142,
))


class ExtPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    t: torch.Tensor
    z: torch.Tensor


class AffinePoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


def _stack(*ts: torch.Tensor) -> torch.Tensor:
    """Field elements of broadcastable shapes stacked on a new first axis."""
    return torch.stack(torch.broadcast_tensors(*ts))


class TedCurve:
    def __init__(self, spec: TwistedEdwardsSpec, device=DEFAULT_DEVICE):
        self.spec = spec
        self.device = torch.device(device)
        self.f: FieldEngine = for_spec(spec.base)
        p = spec.base.modulus
        self._a = spec.a % p
        self._d = spec.d % p
        self._consts: dict = {}

    def _const(self, v: int, like: torch.Tensor) -> torch.Tensor:
        """The Montgomery (W,) constant v on like's device (cached)."""
        key = (v, like.device)
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = self.f.from_int(v, device=like.device)
        return c

    def _sel(self, cond: torch.Tensor, a: ExtPoint, b: ExtPoint) -> ExtPoint:
        return ExtPoint(*(self.f.where(cond, u, v) for u, v in zip(a, b)))

    # -- constructors / conversions -----------------------------------------
    def identity_ext(self, shape=(), device=None) -> ExtPoint:
        f = self.f
        dev = device or self.device
        zero = f.zeros(shape, device=dev)
        one = f.ones(shape, device=dev)
        return ExtPoint(zero, one, zero, one)

    def generator_affine(self, shape=(), device=None) -> AffinePoint:
        f = self.f
        dev = device or self.device
        return AffinePoint(
            f.broadcast_to(f.from_int(self.spec.gx, device=dev), shape),
            f.broadcast_to(f.from_int(self.spec.gy, device=dev), shape))

    def from_affine(self, p: AffinePoint) -> ExtPoint:
        f = self.f
        return ExtPoint(p.x, p.y, f.mul(p.x, p.y),
                        f.ones(f.eshape(p.x), device=p.x.device))

    def to_affine(self, p: ExtPoint) -> AffinePoint:
        f = self.f
        sh = f.eshape(p.z)
        if len(sh) == 0:
            zinv = f.inverse(p.z)
        else:
            zinv = f.batch_inverse(
                p.z.reshape(-1, p.z.shape[-1])).reshape(p.z.shape)
        return AffinePoint(f.mul(p.x, zinv), f.mul(p.y, zinv))

    def on_curve_affine(self, p: AffinePoint) -> torch.Tensor:
        """a*x^2 + y^2 == 1 + d*x^2*y^2 (point.go IsOnCurve)."""
        f = self.f
        x2, y2 = f.square(p.x), f.square(p.y)
        lhs = f.add(f.mul(self._const(self._a, p.x), x2), y2)
        rhs = f.add(self._const(1, p.x).expand_as(x2),
                    f.mul(self._const(self._d, p.x), f.mul(x2, y2)))
        return f.equal(lhs, rhs)

    # -- group law (add-2008-hwcd, unified/complete for a=-1, d non-square) --
    # The formulas are the reference's (twistededwards.py add, double), each
    # value the same canonical residue; their independent products go to one
    # stacked product call and their sums to one stacked add or sub, so a
    # ladder step on one lane is 6 product calls and 4 linear ones (on the
    # card 6 ``mont_mul`` launches), where one call an operation took 20 and
    # 14: a width-1 ladder is bound by its calls.
    def add(self, p: ExtPoint, q: ExtPoint) -> ExtPoint:
        f = self.f
        d, a = self._const(self._d, p.x), self._const(self._a, p.x)
        # A = x1 x2, B = y1 y2, t1 t2, D = z1 z2, and x1 y2, y1 x2, whose sum
        # is E = (x1 + y1)(x2 + y2) - A - B
        A, B, TT, D, XY, YX = f.mul(_stack(p.x, p.y, p.t, p.z, p.x, p.y),
                                    _stack(q.x, q.y, q.t, q.z, q.y, q.x))
        C, aA = f.mul(_stack(TT, A),                   # C = d t1 t2
                      _stack(d.expand_as(TT), a.expand_as(A)))
        E, G = f.add(_stack(XY, D), _stack(YX, C))     # G = D + C
        F, H = f.sub(_stack(D, B), _stack(C, aA))      # F = D - C, H = B - aA
        return ExtPoint(*f.mul(_stack(E, G, E, F), _stack(F, H, H, G)))

    def double(self, p: ExtPoint) -> ExtPoint:
        f = self.f
        two, a = self._const(2, p.x), self._const(self._a, p.x)
        A, B, ZZ, XY = f.mul(_stack(p.x, p.y, p.z, p.x),
                             _stack(p.x, p.y, p.z, p.y))
        # C = 2 z^2, D = a A, E = 2 x y = (x + y)^2 - A - B
        C, D, E = f.mul(_stack(ZZ, A, XY), _stack(*(c.expand_as(A) for c in
                                                   (two, a, two))))
        G = f.add(D, B)
        H, F = f.sub(_stack(D, G), _stack(B, C))       # H = D - B, F = G - C
        return ExtPoint(*f.mul(_stack(E, G, E, F), _stack(F, H, H, G)))

    def neg(self, p: ExtPoint) -> ExtPoint:
        return ExtPoint(self.f.neg(p.x), p.y, self.f.neg(p.t), p.z)

    def scalar_mul(self, p: ExtPoint, k_int_bits: torch.Tensor) -> ExtPoint:
        """Double-and-add over an MSB-first (nbits, ...) bit tensor."""
        rows = k_int_bits.reshape(len(k_int_bits), -1).amax(1).tolist()
        return self._ladder(p, k_int_bits, rows)

    def _ladder(self, p: ExtPoint, bits: torch.Tensor, any_set) -> ExtPoint:
        """Steps whose bit row ``any_set`` marks unset only double."""
        acc = self.identity_ext(self.f.eshape(p.x), device=p.x.device)
        for bit, go in zip(bits, any_set):
            acc = self.double(acc)
            if go:
                acc = self._sel(bit == 1, self.add(acc, p), acc)
        return acc

    def scalar_mul_int(self, p: ExtPoint, k: int | list[int],
                       nbits: int | None = None, regular: bool = False
                       ) -> ExtPoint:
        """Host-int scalar(s); bits sent to the points' device. With
        ``regular`` every step adds and selects, as the JAX ladder does, so
        that the launches and the time do not follow the bits of a secret
        scalar (a key, a nonce); else a step where no lane has its bit set
        only doubles."""
        ks = [k] if isinstance(k, int) else list(k)
        nbits = nbits or max(self.spec.base.modulus.bit_length() + 1,
                             max(ks).bit_length())
        bits, any_set = int_bits(ks, nbits, p.x.device)
        if isinstance(k, int):
            bits = bits[:, 0]
        return self._ladder(p, bits, [True] * nbits if regular else any_set)

    # -- GLV endomorphism (bandersnatch) -------------------------------------
    def phi(self, p: ExtPoint) -> ExtPoint:
        """The degree-2 endomorphism phi = sqrt(-2): phi(P) = [lambda]P on
        the prime subgroup (bandersnatch/endomorpism.go:11 PointExtended.phi,
        projective Montgomery-isogeny composition evaluated in-place)."""
        e0, e1 = self.spec.endo
        f = self.f
        zz = f.square(p.z)
        yy = f.square(p.y)
        xy = f.mul(p.x, p.y)
        fe = f.mul(f.sub(zz, yy), self._const(e1, p.x))
        zz = f.mul(zz, self._const(e0, p.x))
        g = f.mul(f.add(yy, zz), self._const(e0, p.x))
        h = f.sub(yy, zz)
        return ExtPoint(f.mul(fe, h), f.mul(g, xy), f.mul(fe, g),
                        f.mul(h, xy))

    def scalar_mul_glv(self, p: ExtPoint, ks: list[int]) -> ExtPoint:
        """[k]P via GLV split k = k1 + k2*lambda, |ki| ~ sqrt(order), and a
        joint double-and-add — half the doublings of scalar_mul_int
        (bandersnatch/endomorpism.go:29 scalarMulGLV; the batched
        complete-add variant instead of the 4-bit window table)."""
        if self.spec.glv_lambda is None:
            raise ValueError(f"{self.spec.name}: no GLV endomorphism")
        r = self.spec.order
        lam = self.spec.glv_lambda
        basis = _lattice_2d(r, lam)
        k1s, k2s = [], []
        for k in ks:
            k1, k2 = split_scalar(k % r, lam, basis, r)
            k1s.append(k1)
            k2s.append(k2)

        dev = p.x.device
        neg1 = torch.tensor([k < 0 for k in k1s], device=dev)
        p1 = self._sel(neg1, self.neg(p), p)
        pp = self.phi(p)
        neg2 = torch.tensor([k < 0 for k in k2s], device=dev)
        p2 = self._sel(neg2, self.neg(pp), pp)

        m1 = [abs(k) for k in k1s]
        m2 = [abs(k) for k in k2s]
        nbits = max(max(m1).bit_length(), max(m2).bit_length(), 1)
        b1, any1 = int_bits(m1, nbits, dev)
        b2, any2 = int_bits(m2, nbits, dev)
        acc = self.identity_ext(self.f.eshape(p.x), device=dev)
        for r1, r2, a1, a2 in zip(b1, b2, any1, any2):
            acc = self.double(acc)
            if a1:
                acc = self._sel(r1 == 1, self.add(acc, p1), acc)
            if a2:
                acc = self._sel(r2 == 1, self.add(acc, p2), acc)
        return acc

    # -- serialization (point.go:52 Bytes / :96 SetBytes, RFC8032-style) ----
    def point_to_bytes(self, p: AffinePoint) -> list[bytes]:
        f = self.f
        nb = self.spec.base.n_bytes
        q = self.spec.base.modulus
        xs = f.to_int(p.x)
        ys = f.to_int(p.y)
        if not isinstance(xs, list):
            xs, ys = [xs], [ys]
        out = []
        for x, y in zip(xs, ys):
            yb = bytearray(y.to_bytes(nb, "big"))
            if x > (q - 1) // 2:  # LexicographicallyLargest
                yb[0] |= 0x80
            out.append(bytes(reversed(yb)))  # little-endian on the wire
        return out

    def point_from_bytes(self, bufs: list[bytes], device=None
                         ) -> AffinePoint:
        f = self.f
        q = self.spec.base.modulus
        nb = self.spec.base.n_bytes
        xs, ys = [], []
        for buf in bufs:
            be = bytearray(reversed(buf[:nb]))
            neg = bool(be[0] & 0x80)
            be[0] &= 0x7F
            y = int.from_bytes(be, "big")
            if y >= q:
                raise ValueError("non-canonical y")
            # x^2 = (1 - y^2) / (a - d*y^2)
            y2 = y * y % q
            num = (1 - y2) % q
            den = (self._a - self._d * y2) % q
            x2 = num * pow(den, -1, q) % q
            x = pow(x2, (q + 1) // 4, q) if q % 4 == 3 else _tonelli_int(x2, q)
            if x * x % q != x2:
                raise ValueError("invalid compressed point")
            if (x > (q - 1) // 2) != neg:
                x = (-x) % q
            xs.append(x)
            ys.append(y)
        dev = device or self.device
        return AffinePoint(f.from_int(xs, device=dev),
                           f.from_int(ys, device=dev))


def _tonelli_int(n: int, p: int) -> int:
    """Host Tonelli-Shanks for decompression on q = 1 mod 4 fields."""
    if n == 0:
        return 0
    if pow(n, (p - 1) // 2, p) != 1:
        return 0
    s, t = 0, p - 1
    while t % 2 == 0:
        s, t = s + 1, t // 2
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, u, r = s, pow(z, t, p), pow(n, t, p), pow(n, (t + 1) // 2, p)
    while u != 1:
        i, v = 0, u
        while v != 1:
            v = v * v % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        u, r = u * c % p, r * b % p
    return r


@functools.lru_cache(maxsize=None)
def _ted_curve(name: str, device: torch.device) -> TedCurve:
    return TedCurve(get_ted(name), device)


def ted_curve(name: str, device=DEFAULT_DEVICE) -> TedCurve:
    """The registered curve ``name`` on ``device``, one per (name,
    device)."""
    return _ted_curve(name, torch.device(device))
