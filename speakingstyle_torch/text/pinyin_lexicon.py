"""Generator for the Mandarin pinyin MFA lexicon (pinyin-lexicon-r.txt).

The reference vendors this dictionary as a static data file
(reference: lexicon/pinyin-lexicon-r.txt, 4120 entries) — AISHELL3
preprocessing (MFA alignment) and pinyin g2p at synthesis time both
consume it, and its phone inventory must line up one-to-one with
``text/phonesets.py`` or embedding rows stop matching checkpoints.

Instead of vendoring an opaque table we REGENERATE it from standard
pinyin phonology: each syllable-with-tone decomposes into
``initial final+tone [rr]`` where

  * zh/ch/sh/r + "i" use the retroflex final ``iii``; z/c/s + "i" the
    apical ``ii``
  * j/q/x(+y) neutralize u -> ümlaut: u->v, ue->ve, uan->van, un->vn
  * the contracted finals expand: iu->iou, ui->uei, un->uen
  * pseudo-initials y/w keep their letter and expand to the full
    i-/u- series final (yi -> y i, wen -> w uen; weng merges to uen,
    yo/you both to iou — quirks preserved for row parity)
  * erhua (-r) appends the standalone ``rr`` phone

``write_lexicon(path)`` emits the file: all plain syllable entries
sorted by (syllable, tone), then all erhua entries. Run
``python -m speakingstyle_torch.text.pinyin_lexicon --out lexicon/pinyin-lexicon-r.txt``.

Content parity: the generated file is LINE-SET IDENTICAL to the
reference's data file (4120 entries; verified by
tests/test_text.py::test_pinyin_lexicon_generator). The only raw
diff is line ORDER for 60 lines: the reference file was hand-edited, with
``r1..r5`` spliced in before ``er*`` and the ``lve*``/``nve*`` spelling
variants spliced immediately after ``lue*``/``nue*`` instead of in sorted
position. Lexicon lookup (MFA and ``text/g2p.py``) is order-independent,
so we keep deterministic sorted order rather than reproducing the manual
insertion points.
"""

import argparse

# The standard Mandarin syllabary (412 pinyin syllables as used by the
# AISHELL3 corpus' MFA dictionary; includes the interjection/colloquial
# forms lo, me, yo, den, dia, rua, tei, kei, zhei, shei, nou and the
# standalone retroflex "r").
PLAIN_SYLLABLES = """
a ai an ang ao ba bai ban bang bao bei ben beng bi bian biao bie bin
bing bo bu ca cai can cang cao ce cen ceng cha chai chan chang chao che
chen cheng chi chong chou chu chuai chuan chuang chui chun chuo ci cong
cou cu cuan cui cun cuo da dai dan dang dao de dei den deng di dia dian
diao die ding diu dong dou du duan dui dun duo e ei en eng er fa fan
fang fei fen feng fo fou fu ga gai gan gang gao ge gei gen geng gong
gou gu gua guai guan guang gui gun guo ha hai han hang hao he hei hen
heng hong hou hu hua huai huan huang hui hun huo ji jia jian jiang jiao
jie jin jing jiong jiu ju juan jue jun ka kai kan kang kao ke kei ken
keng kong kou ku kua kuai kuan kuang kui kun kuo la lai lan lang lao le
lei leng li lia lian liang liao lie lin ling liu lo long lou lu luan
lue lun luo lv lve ma mai man mang mao me mei men meng mi mian miao mie
min ming miu mo mou mu na nai nan nang nao ne nei nen neng ni nian
niang niao nie nin ning niu nong nou nu nuan nue nuo nv nve o ou pa
pai pan pang pao pei pen peng pi pian piao pie pin ping po pou pu qi
qia qian qiang qiao qie qin qing qiong qiu qu quan que qun r ran rang
rao re ren reng ri rong rou ru rua ruan rui run ruo sa sai san sang
sao se sen seng sha shai shan shang shao she shei shen sheng shi shou
shu shua shuai shuan shuang shui shun shuo si song sou su suan sui sun
suo ta tai tan tang tao te tei teng ti tian tiao tie ting tong tou tu
tuan tui tun tuo wa wai wan wang wei wen weng wo wu xi xia xian xiang
xiao xie xin xing xiong xiu xu xuan xue xun ya yan yang yao ye yi yin
ying yo yong you yu yuan yue yun za zai zan zang zao ze zei zen zeng
zha zhai zhan zhang zhao zhe zhei zhen zheng zhi zhong zhou zhu zhua
zhuai zhuan zhuang zhui zhun zhuo zi zong zou zu zuan zui zun zuo
""".split()

ZERO_INITIAL = {"a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng",
                "er", "o", "ou"}
_INITIALS = ("zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
             "g", "k", "h", "j", "q", "x", "r", "z", "c", "s")
_V_SERIES = {"u": "v", "ue": "ve", "uan": "van", "un": "vn"}
_CONTRACTED = {"iu": "iou", "ui": "uei", "un": "uen", "ue": "ve"}
TONES = "12345"


def decompose(syllable: str):
    """Base pinyin syllable (no tone, no erhua) -> (initial|None, final)."""
    s = syllable
    if s in ZERO_INITIAL:
        return None, s
    if s == "r":  # standalone retroflex syllable, e.g. 儿 in casual text
        return None, "er"
    if s[0] == "y":
        rest = s[1:]
        if rest.startswith("u"):  # yu-series neutralizes to v
            return "y", _V_SERIES.get(rest, "v" + rest[1:])
        if s == "yo" or s == "you":
            return "y", "iou"
        return "y", rest if rest.startswith("i") else "i" + rest
    if s[0] == "w":
        rest = s[1:]
        if s == "weng":  # merged with uen in this phone set
            return "w", "uen"
        return "w", rest if rest.startswith("u") else "u" + rest
    for ini in _INITIALS:
        if s.startswith(ini) and len(s) > len(ini):
            rest = s[len(ini):]
            if rest == "i" and ini in ("zh", "ch", "sh", "r"):
                return ini, "iii"
            if rest == "i" and ini in ("z", "c", "s"):
                return ini, "ii"
            if ini in ("j", "q", "x") and rest in _V_SERIES:
                return ini, _V_SERIES[rest]
            return ini, _CONTRACTED.get(rest, rest)
    raise ValueError(f"cannot decompose pinyin syllable {syllable!r}")


def entries():
    """Yield (key, [phones]) in the file's order: plain block, then erhua."""
    for s in sorted(PLAIN_SYLLABLES):
        ini, fin = decompose(s)
        for t in TONES:
            phones = ([ini] if ini else []) + [fin + t]
            yield f"{s}{t}", phones
    for s in sorted(PLAIN_SYLLABLES):
        if s in ("r", "er"):  # already end in r: no -r erhua key of their own
            continue
        ini, fin = decompose(s)
        for t in TONES:
            phones = ([ini] if ini else []) + [fin + t, "rr"]
            yield f"{s}r{t}", phones


def write_lexicon(path: str) -> int:
    n = 0
    with open(path, "w", encoding="utf-8") as f:
        for key, phones in entries():
            f.write(f"{key} {' '.join(phones)}\n")
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="lexicon/pinyin-lexicon-r.txt")
    args = ap.parse_args(argv)
    import os

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n = write_lexicon(args.out)
    print(f"wrote {n} entries to {args.out}")


if __name__ == "__main__":
    main()
