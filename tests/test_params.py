"""Grain LFSR + default-parameter golden vectors (bit-exact vs the Rust reference).

Vectors transcribed from:
  * /root/reference/src/poseidon/grain_lfsr.rs:197-213  (first two rejection draws)
  * /root/reference/src/poseidon/traits.rs:163-358      (14 default configs)
"""

import pytest

from sponge_jax.fields import BLS12_381_FR
from sponge_jax.poseidon.params import (
    PoseidonGrainLFSR,
    get_default_poseidon_parameters,
)

FR = BLS12_381_FR


def test_grain_lfsr_golden():
    lfsr = PoseidonGrainLFSR(False, 255, 3, 8, 31)
    first = lfsr.get_field_elements_rejection_sampling(FR, 1)[0]
    second = lfsr.get_field_elements_rejection_sampling(FR, 1)[0]
    assert first == 27117311055620256798560880810000042840428971800021819916023577129547249660720
    assert second == 51641662388546346858987925410984003801092143452466182801674685248597955169158


# (rate, optimized_for_weights) -> (ark[0][0], mds[0][0]); traits.rs:163-358.
GOLDEN = {
    (2, False): (
        27117311055620256798560880810000042840428971800021819916023577129547249660720,
        26017457457808754696901916760153646963713419596921330311675236858336250747575,
    ),
    (3, False): (
        11865901593870436687704696210307853465124332568266803587887584059192277437537,
        18791275321793747281053101601584820964683215017313972132092847596434094368732,
    ),
    (4, False): (
        41775194144383840477168997387904574072980173775424253289429546852163474914621,
        42906651709148432559075674119637355642263148226238482628104108168707874713729,
    ),
    (5, False): (
        24877380261526996562448766783081897666376381975344509826094208368479247894723,
        30022080821787948421423927053079656488514459012053372877891553084525866347732,
    ),
    (6, False): (
        37928506567864057383105673253383925733025682403141583234734361541053005808936,
        49124738641420159156404016903087065194698370461819821829905285681776084204443,
    ),
    (7, False): (
        37848764121158464546907147011864524711588624175161409526679215525602690343051,
        28113878661515342855868752866874334649815072505130059513989633785080391114646,
    ),
    (8, False): (
        51456871630395278065627483917901523970718884366549119139144234240744684354360,
        12929023787467701044434927689422385731071756681420195282613396560814280256210,
    ),
    (2, True): (
        25126470399169474618535500283750950727260324358529540538588217772729895991183,
        46350838805835525240431215868760423854112287760212339623795708191499274188615,
    ),
    (3, True): (
        16345358380711600255519479157621098002794924491287389755192263320486827897573,
        37432344439659887296708509941462699942272362339508052702346957525719991245918,
    ),
    (4, True): (
        2997721997773001075802235431463112417440167809433966871891875582435098138600,
        43959024692079347032841256941012668338943730711936867712802582656046301966186,
    ),
    (5, True): (
        28142027771717376151411984909531650866105717069245696861966432993496676054077,
        13157425078305676755394500322568002504776463228389342308130514165393397413991,
    ),
    (6, True): (
        7417004907071346600696060525974582183666365156576759507353305331252133694222,
        51393878771453405560681338747290999206747890655420330824736778052231938173954,
    ),
    (7, True): (
        47093173418416013663709314805327945458844779999893881721688570889452680883650,
        51455917624412053400160569105425532358410121118308957353565646758865245830775,
    ),
    (8, True): (
        16478680729975035007348178961232525927424769683353433314299437589237598655079,
        39160448583049384229582837387246752222769278402304070376350288593586064961857,
    ),
}


@pytest.mark.parametrize("rate", range(2, 9))
@pytest.mark.parametrize("weights", [False, True], ids=["constraints", "weights"])
def test_default_params_golden(rate, weights):
    cfg = get_default_poseidon_parameters(FR, rate, weights)
    ark00, mds00 = GOLDEN[(rate, weights)]
    assert cfg.ark[0][0] == ark00
    assert cfg.mds[0][0] == mds00
    assert cfg.capacity == 1
    assert cfg.rate == rate
    assert len(cfg.ark) == cfg.full_rounds + cfg.partial_rounds


def test_register_default_table():
    """User-extensible default-table registry (reference extensibility parity:
    any field may implement PoseidonDefaultConfig, traits.rs:43-66)."""
    from conftest import TINY_FR_45

    from sponge_jax.poseidon.params import register_default_table

    # A never-registered field has no defaults...
    with pytest.raises(KeyError):
        get_default_poseidon_parameters(TINY_FR_45, 2)

    # ...until registered; then the full param-gen path (Grain LFSR + Cauchy
    # MDS + capacity override) runs for it.
    register_default_table(TINY_FR_45, [(2, 5, 4, 3, 0), (3, 5, 4, 3, 1)], capacity=2)
    cfg = get_default_poseidon_parameters(TINY_FR_45, 2)
    assert (cfg.rate, cfg.capacity, cfg.t) == (2, 2, 4)
    assert (cfg.alpha, cfg.full_rounds, cfg.partial_rounds) == (5, 4, 3)
    assert len(cfg.ark) == 7 and all(len(r) == 4 for r in cfg.ark)
    assert len(cfg.mds) == 4 and all(len(r) == 4 for r in cfg.mds)
    p = TINY_FR_45.modulus
    assert all(0 <= v < p for row in cfg.ark for v in row)
    # deterministic: same registration -> same constants; skip_matrices shifts
    # the MDS draw stream (traits.rs:127-129)
    cfg2 = get_default_poseidon_parameters(TINY_FR_45, 2)
    assert cfg2.ark == cfg.ark and cfg2.mds == cfg.mds
    cfg3 = get_default_poseidon_parameters(TINY_FR_45, 3)
    assert cfg3.t == 5

    # unknown rate still raises ValueError (reference returns None)
    with pytest.raises(ValueError):
        get_default_poseidon_parameters(TINY_FR_45, 7)

    # malformed rows are rejected — in EITHER table, at registration time
    # (not as an opaque unpack error at a later lookup)
    with pytest.raises(ValueError):
        register_default_table(TINY_FR_45, [(2, 5, 4)])
    with pytest.raises(ValueError):
        register_default_table(
            TINY_FR_45, [(2, 5, 4, 3, 0)], optimized_for_weights_table=[(2, 5, 4)]
        )
