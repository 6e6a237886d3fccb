"""Entity joining and per-dataset result filters (a copy of
``vibertgrid_tpu/eval/entities.py``; numpy only).

``join_entities`` ports the greedy run-merge used by both the validate loop
(the reference's ``pipeline/train_val_utils.py:439-518``) and the eval CLIs
(``eval_SROIE.py:119-169``): consecutive segments predicted the same class
merge into one candidate string (space-joined for English unless the prefix
ends with '-', directly concatenated for Chinese), each candidate scored by
its mean softmax confidence, and the best candidate per class selected.

``sroie_result_filter`` ports the date/total regexes of
``eval_SROIE.py:20-72``; ``ephoie_result_filter`` ports the key-word strip /
subject / grade / school filters of ``eval_EPHOIE.py:32-155``.
"""

from __future__ import annotations

import re

import numpy as np


def join_entities(
    probs: np.ndarray,
    texts: list[str],
    num_classes: int,
    language: str = "eng",
    score_thresh: float = 0.0,
) -> list[str]:
    """probs [S, C] softmax scores per valid segment → best string per class.

    Returns a list of ``num_classes`` strings ('' when nothing predicted).
    """
    assert probs.shape[0] == len(texts)
    candidates = [[] for _ in range(num_classes)]
    curr_str = ""
    curr_score = 0.0
    curr_len = 0
    prev_class = -1
    n = len(texts)
    for i in range(n):
        cls = int(np.argmax(probs[i]))
        score = float(probs[i, cls])
        if score < score_thresh:
            cls = 0
        if cls == prev_class:
            if language == "eng":
                curr_str += texts[i] if curr_str.endswith("-") else " " + texts[i]
            else:
                curr_str += texts[i]
            curr_score += score
            curr_len += 1
        else:
            if prev_class >= 0:
                candidates[prev_class].append((curr_str, curr_score / curr_len))
            curr_str = texts[i]
            curr_score = score
            curr_len = 1
        if i == n - 1:
            # Reference quirk preserved: the final run is appended under
            # prev_class *before* prev_class is updated to the current class
            # (eval_SROIE.py:148-153), i.e. under the previous run's class
            # unless the last two segments share one.
            candidates[prev_class].append((curr_str, curr_score / curr_len))
        prev_class = cls

    best = []
    for class_candidates in candidates:
        if not class_candidates:
            best.append("")
            continue
        max_score, max_idx = 0.0, 0
        for idx, (_, score) in enumerate(class_candidates):
            if score > max_score:
                max_score, max_idx = score, idx
        best.append(class_candidates[max_idx][0])
    return best


# The reference embeds an inline (?i) mid-pattern (eval_SROIE.py:27) which
# Python >= 3.11 rejects; the flag moved to re.IGNORECASE (same semantics).
_DATE_RE = re.compile(
    r"((?:[12][0-9]|3[01]|0*[1-9])(?P<sep>[- \/.\\])(?P=sep)*(?:1[012]|0*[1-9]|jan(?:uary)?|feb("
    r"?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug(?:ust)?|sep(?:tember)?|oct(?:ober)?|nov("
    r"?:ember)?|dec(?:ember)?)(?P=sep)+(?:19|20)\d\d|(?:[12][0-9]|3[01]|0*[1-9])(?P<sep2>[- \/.\\])("
    r"?P=sep2)*(?:1[012]|0*[1-9]|jan(?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul("
    r"?:y)?|aug(?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec(?:ember)?)(?P=sep2)+\d\d|(?:1[012]|0*["
    r"1-9]|jan(?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug(?:ust)?|sep("
    r"?:tember)?|oct(?:ober)?|nov(?:ember)?|dec(?:ember)?)(?P<sep3>[- \/.\\])(?P=sep3)*(?:[12][0-9]|3[01]|0*["
    r"1-9])(?P=sep3)+(?:19|20)\d\d|(?:1[012]|0*[1-9]|jan(?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr("
    r"?:il)?|may|jun(?:e)?|jul(?:y)?|aug(?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec(?:ember)?)("
    r"?P<sep4>[- \/.\\])(?P=sep4)*(?:[12][0-9]|3[01]|0*[1-9])(?P=sep4)+\d\d|(?:19|20)\d\d(?P<sep5>[- \/.\\])("
    r"?P=sep5)*(?:1[012]|0*[1-9]|jan(?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul("
    r"?:y)?|aug(?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec(?:ember)?)(?P=sep5)+(?:[12][0-9]|3["
    r"01]|0*[1-9])|\d\d(?P<sep6>[- \/.\\])(?P=sep6)*(?:1[012]|0*[1-9]|jan(?:uary)?|feb(?:ruary)?|mar("
    r"?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug(?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec("
    r"?:ember)?)(?P=sep6)+(?:[12][0-9]|3[01]|0*[1-9])|(?:[12][0-9]|3[01]|0*[1-9])(?:jan(?:uary)?|feb("
    r"?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug(?:ust)?|sep(?:tember)?|oct(?:ober)?|nov("
    r"?:ember)?|dec(?:ember)?)(?:19|20)\d\d|(?:[12][0-9]|3[01]|0*[1-9])(?:jan(?:uary)?|feb(?:ruary)?|mar("
    r"?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug(?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec("
    r"?:ember)?)\d\d|(?:jan(?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug("
    r"?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec(?:ember)?)(?:[12][0-9]|3[01]|0*[1-9])("
    r"?:19|20)\d\d|(?:jan(?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug("
    r"?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec(?:ember)?)(?:[12][0-9]|3[01]|0*[1-9])\d\d|("
    r"?:19|20)\d\d(?:jan(?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug("
    r"?:ust)?|sep(?:tember)?|oct(?:ober)?|nov(?:ember)?|dec(?:ember)?)(?:[12][0-9]|3[01]|0*[1-9])|\d\d(?:jan("
    r"?:uary)?|feb(?:ruary)?|mar(?:ch)?|apr(?:il)?|may|jun(?:e)?|jul(?:y)?|aug(?:ust)?|sep(?:tember)?|oct("
    r"?:ober)?|nov(?:ember)?|dec(?:ember)?)(?:[12][0-9]|3[01]|0[1-9])|(?:[12][0-9]|3[01]|0[1-9])(?:1[012]|0["
    r"1-9])(?:19|20)\d\d|(?:1[012]|0[1-9])(?:[12][0-9]|3[01]|0[1-9])(?:19|20)\d\d|(?:19|20)\d\d(?:1[012]|0["
    r"1-9])(?:[12][0-9]|3[01]|0[1-9])|(?:1[012]|0[1-9])(?:[12][0-9]|3[01]|0[1-9])\d\d|(?:[12][0-9]|3[01]|0["
    r"1-9])(?:1[012]|0[1-9])\d\d|\d\d(?:1[012]|0[1-9])(?:[12][0-9]|3[01]|0[1-9]))",
    re.IGNORECASE,
)
_TOTAL_RE = re.compile(r"^\d+(\.\d+)?$")


def sroie_result_filter(raw_string: str, class_index: int):
    """Date/total post filters (eval_SROIE.py:20-72). Returns the filtered
    string or None when the regex rejects (the reference then crashes on
    len(None); callers treat None as '')."""
    if class_index in (1, 3):  # company, address pass through
        return raw_string
    if class_index == 2:  # date
        m = _DATE_RE.match(raw_string)
        return m[0] if m is not None else None
    if class_index == 4:  # total
        m = _TOTAL_RE.search(raw_string)
        return m[0] if m is not None else None
    return raw_string


EPHOIE_FILTER_WORDS = [
    "年级", "科目", "学校", "考试时间", "班级", "姓名", "考号",
    "分数", "座号", "学号", "准考证号", "：", ":", "得分", "等级", "班次",
]

EPHOIE_SUBJECTS = [
    "语文", "数学", "英语", "政治", "道德与法治", "思想品德", "历史", "地理",
    "生物", "化学", "物理", "文综", "文科综合", "理综", "理科综合", "科学",
    "历史与社会", "品德与社会", "语文", "历史与社会·道德与法治", "数据的分析",
    "地理生物",
]


def _strip_indices(raw: str, extra_lead: bool, lead_word: str | None) -> str:
    drop: set[int] = set()
    if lead_word is not None and raw.find(lead_word) == 0 and extra_lead:
        drop.update((0, 1))
    for w in EPHOIE_FILTER_WORDS:
        idx = raw.find(w)
        if idx < 0:
            continue
        drop.update(range(idx, idx + len(w)))
    return "".join(ch for i, ch in enumerate(raw) if i not in drop)


def ephoie_result_filter(raw_string: str, class_index: int) -> str:
    """EPHOIE key-word strip / subject / grade / school filters
    (eval_EPHOIE.py:32-155). The reference's subject branch returns a string
    where an index list is expected (a latent TypeError); we implement the
    evident intent: return the matched subject when found mid-string."""
    if class_index == 2:  # 科目 (subject)
        for item in EPHOIE_SUBJECTS:
            if raw_string.find(item) > 0:
                return item
        return raw_string
    if class_index == 1:  # 年级 (grade)
        return _strip_indices(raw_string, True, "年级")
    if class_index == 3:  # 学校 (school)
        return _strip_indices(raw_string, True, "学校")
    return _strip_indices(raw_string, False, None)
