"""Synthetic clinical-note corpus generator (mirrors the paper's data).

Port of ``repro.data.corpus``: the same ``np.random.RandomState`` draws
in the same order, so the same seeds give the same strings.

The paper's test sets (§9.1, §10) are i2b2/UTHealth notes plus synthetic
near-duplicates made by randomly changing 0-20% of a note's words.  We
can't ship i2b2 (restricted), so ``make_i2b2_like`` generates
clinical-note-shaped documents from templated sections (the pervasive
templates are exactly WHY clinical corpora are duplicate-heavy, paper §1)
and ``inject_near_duplicates`` reproduces the paper's perturbation
protocol exactly.
"""
from __future__ import annotations


import numpy as np

_SECTIONS = [
    "CHIEF COMPLAINT : {complaint} .",
    "HISTORY OF PRESENT ILLNESS : The patient is a {age} year old "
    "{sex} presenting with {complaint} for the past {num} days . "
    "Symptoms include {sym1} and {sym2} . Denies {sym3} .",
    "PAST MEDICAL HISTORY : {pmh1} , {pmh2} , status post {procedure} "
    "in {year} .",
    "MEDICATIONS : {med1} {dose1} mg daily , {med2} {dose2} mg twice "
    "daily , {med3} as needed .",
    "ALLERGIES : {allergy} .",
    "PHYSICAL EXAM : Vital signs temperature {temp} pulse {pulse} "
    "blood pressure {bp1} over {bp2} . {exam} .",
    "ASSESSMENT AND PLAN : {assessment} . Will start {med1} and follow "
    "up in {num} weeks . Patient counseled on {counsel} .",
    "LABS : sodium {lab1} potassium {lab2} creatinine {lab3} glucose "
    "{lab4} white count {lab5} .",
]

_VOCAB = {
    "complaint": ["chest pain", "shortness of breath", "abdominal pain",
                  "headache", "dizziness", "fatigue", "back pain",
                  "palpitations", "fever", "cough"],
    "sex": ["male", "female"],
    "sym1": ["nausea", "vomiting", "diaphoresis", "chills", "weakness"],
    "sym2": ["radiation to the left arm", "photophobia", "orthopnea",
             "dysuria", "myalgias"],
    "sym3": ["fever", "chills", "weight loss", "night sweats", "syncope"],
    "pmh1": ["hypertension", "diabetes mellitus type 2", "asthma",
             "atrial fibrillation", "hyperlipidemia"],
    "pmh2": ["chronic kidney disease", "coronary artery disease",
             "obstructive sleep apnea", "hypothyroidism", "anemia"],
    "procedure": ["appendectomy", "cholecystectomy", "cabg",
                  "total knee replacement", "hernia repair"],
    "med1": ["lisinopril", "metformin", "atorvastatin", "amlodipine",
             "metoprolol"],
    "med2": ["aspirin", "omeprazole", "levothyroxine", "gabapentin",
             "furosemide"],
    "med3": ["acetaminophen", "ibuprofen", "ondansetron", "albuterol"],
    "allergy": ["no known drug allergies", "penicillin", "sulfa drugs",
                "codeine", "latex"],
    "exam": ["lungs clear to auscultation bilaterally",
             "regular rate and rhythm no murmurs",
             "abdomen soft nontender nondistended",
             "no lower extremity edema",
             "alert and oriented times three"],
    "assessment": ["acute coronary syndrome ruled out",
                   "community acquired pneumonia",
                   "urinary tract infection",
                   "exacerbation of chronic condition",
                   "dehydration with electrolyte abnormalities"],
    "counsel": ["medication compliance", "smoking cessation",
                "dietary modification", "warning signs requiring return"],
}


def make_i2b2_like(n_notes: int = 521, seed: int = 0) -> list[str]:
    """Clinical-note-shaped documents, a few hundred words each (paper §7.1)."""
    rng = np.random.RandomState(seed)
    notes = []
    for _ in range(n_notes):
        parts = []
        for sec in _SECTIONS:
            fills = {k: rng.choice(v) for k, v in _VOCAB.items()}
            fills.update(
                age=rng.randint(18, 95), num=rng.randint(1, 14),
                year=rng.randint(1990, 2016), dose1=rng.choice([5, 10, 20, 40]),
                dose2=rng.choice([25, 50, 100]), temp=rng.randint(97, 103),
                pulse=rng.randint(55, 120), bp1=rng.randint(95, 180),
                bp2=rng.randint(55, 110), lab1=rng.randint(130, 148),
                lab2=round(rng.uniform(3.2, 5.4), 1),
                lab3=round(rng.uniform(0.6, 3.0), 1),
                lab4=rng.randint(70, 260), lab5=round(rng.uniform(4, 15), 1),
            )
            parts.append(sec.format(**fills))
            # Repeat some sections to pad to a few hundred words.
        note = " ".join(parts)
        # Duplicate the HPI/plan with tiny edits (template copy-paste).
        notes.append(note + " " + parts[1] + " " + parts[-2])
    return notes


def perturb(text: str, frac: float, rng) -> str:
    """Randomly change ``frac`` of the words (paper §9.1/§10 protocol)."""
    words = text.split()
    n = int(len(words) * frac)
    if n:
        idx = rng.choice(len(words), size=n, replace=False)
        pool = [w for v in _VOCAB.values() for w in v]
        for i in idx:
            words[i] = rng.choice(pool).split()[0]
    return " ".join(words)


def inject_near_duplicates(
    notes: list[str], n_dups: int, *, frac_low=0.0, frac_high=0.2,
    seed: int = 1,
) -> tuple[list[str], list[tuple[int, int, float]]]:
    """Paper §10: pick random notes, change 0-20%% of words, append.

    Returns (augmented notes, provenance [(dup_idx, src_idx, frac)]).
    """
    rng = np.random.RandomState(seed)
    out = list(notes)
    prov = []
    for _ in range(n_dups):
        src = rng.randint(len(notes))
        frac = rng.uniform(frac_low, frac_high)
        out.append(perturb(notes[src], frac, rng))
        prov.append((len(out) - 1, src, frac))
    return out, prov


def accuracy_testset(seed: int = 0):
    """Paper §9.1: 521 notes + 10 near-duplicates (10% words changed)."""
    notes = make_i2b2_like(521, seed=seed)
    rng = np.random.RandomState(seed + 1)
    srcs = rng.choice(len(notes), size=10, replace=False)
    dups = [perturb(notes[s], 0.10, rng) for s in srcs]
    return notes + dups, list(srcs)


def clustering_testset(seed: int = 0):
    """Paper §10: same base + 500 near-duplicates at 0-20%."""
    notes = make_i2b2_like(521, seed=seed)
    return inject_near_duplicates(notes, 500, seed=seed + 1)
