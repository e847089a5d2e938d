"""MIST — Multi-level Intelligent Sensitivity Tracker (paper Sec VII).

Stage 1: regex battery (~50 patterns) for PII / HIPAA / financial content
with sensitivity floors (PII >= 0.8, HIPAA >= 0.9, financial >= 0.9).
Stage 2: contextual classifier (public 0.2 / internal 0.5 / confidential 0.8
/ restricted 1.0). The paper uses a local 7B model; here it is an in-repo
JAX hashed char-n-gram classifier (see mist_model) trained by our own
training substrate — same interface, honest latency accounting.

s_r = max(stage1, stage2). A crashed MIST fails conservative: s_r = 1.0.

Sanitization: entity extraction feeds the reversible typed-placeholder store
(Sec VII-B). Sanitization is BYPASSED for intra-personal-group routing
(P=1.0) and MANDATORY when crossing into Tier 3.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.placeholder import PlaceholderStore

# --------------------------------------------------------------- stage 1

# (name, regex, sensitivity floor, placeholder type)
_P = [
    # contact / identity PII  (floor 0.8)
    ("email", r"\b[\w.+-]+@[\w-]+\.[\w.]+\b", 0.8, "CONTACT"),
    ("phone_us", r"\b(?:\+?1[-. ])?\(?\d{3}\)?[-. ]\d{3}[-. ]\d{4}\b", 0.8, "CONTACT"),
    ("phone_intl", r"\+\d{1,3}[ -]?\d{6,12}\b", 0.8, "CONTACT"),
    ("ssn", r"\b\d{3}-\d{2}-\d{4}\b", 0.9, "ID"),
    ("passport", r"\b[A-Z]{1,2}\d{6,9}\b", 0.8, "ID"),
    ("ip_addr", r"\b(?:\d{1,3}\.){3}\d{1,3}\b", 0.8, "ID"),
    ("mac_addr", r"\b(?:[0-9A-Fa-f]{2}:){5}[0-9A-Fa-f]{2}\b", 0.8, "ID"),
    ("dob", r"\b(?:DOB|date of birth)[:\s]+\d{1,4}[-/]\d{1,2}[-/]\d{1,4}\b", 0.9, "TEMPORAL_REFERENCE"),
    ("date", r"\b\d{1,2}/\d{1,2}/\d{2,4}\b", 0.5, "TEMPORAL_REFERENCE"),
    ("iso_date", r"\b\d{4}-\d{2}-\d{2}\b", 0.5, "TEMPORAL_REFERENCE"),
    ("address", r"\b\d{1,5}\s+[A-Z][a-z]+\s+(?:St|Ave|Rd|Blvd|Lane|Drive|Dr|Court|Ct)\b", 0.8, "LOCATION"),
    ("zip", r"\b[A-Z]{2}\s\d{5}(?:-\d{4})?\b", 0.7, "LOCATION"),
    # financial  (floor 0.9)
    ("credit_card", r"\b(?:\d[ -]?){13,16}\b", 0.9, "FINANCIAL"),
    ("iban", r"\b[A-Z]{2}\d{2}[A-Z0-9]{10,30}\b", 0.9, "FINANCIAL"),
    ("routing", r"\baccount(?:\s+number)?[:\s#]+\d{6,17}\b", 0.9, "FINANCIAL"),
    ("swift", r"\b[A-Z]{6}[A-Z0-9]{2}(?:[A-Z0-9]{3})?\b", 0.6, "FINANCIAL"),
    ("salary", r"\$\s?\d{2,3}(?:,\d{3})+(?:\.\d+)?\b", 0.6, "FINANCIAL"),
    # credentials
    ("api_key", r"\b(?:sk|pk|key|token)[-_][A-Za-z0-9]{16,}\b", 0.9, "ID"),
    ("aws_key", r"\bAKIA[0-9A-Z]{16}\b", 0.9, "ID"),
    ("password", r"\b(?:password|passwd|pwd)\s*[:=]\s*\S+", 0.9, "ID"),
    ("private_key", r"-----BEGIN (?:RSA |EC )?PRIVATE KEY-----", 1.0, "ID"),
    # HIPAA / medical  (floor 0.9)
    ("icd10", r"\b[A-TV-Z]\d{2}(?:\.\d{1,4})?\b", 0.9, "MEDICAL_CONDITION"),
    ("mrn", r"\b(?:MRN|medical record)[:\s#]+\w+\b", 0.9, "ID"),
    ("npi", r"\bNPI[:\s#]+\d{10}\b", 0.9, "ID"),
    ("diagnosis", r"\b(?:diagnos(?:is|ed)|prognosis)\b", 0.9, "MEDICAL_CONDITION"),
    # condition/medication mentions alone are moderate (a general question
    # about diabetes is s~0.3-0.5 per the paper's own example); they only
    # reach HIPAA level when an identity pattern co-occurs (compound rule in
    # stage1).
    ("conditions", r"\b(?:diabet(?:es|ic)|cancer|HIV|AIDS|hypertension|asthma|depression|schizophrenia|hepatitis|epilepsy|HbA1c)\b", 0.4, "MEDICAL_CONDITION"),
    ("medications", r"\b(?:metformin|insulin|lisinopril|atorvastatin|amoxicillin|sertraline|ibuprofen|oxycodone|prednisone|warfarin)\b", 0.5, "MEDICAL_CONDITION"),
    ("patient_ref", r"\b[Pp]atient\b", 0.9, None),
    ("phi_terms", r"\b(?:symptom|treatment plan|lab result|biopsy|chemotherapy)\b", 0.9, None),
    # legal / corporate
    ("privileged", r"\b(?:attorney[- ]client|privileged\s+(?:and\s+)?confidential)\b", 1.0, None),
    ("case_no", r"\b(?:case|docket)\s+(?:no\.?|number)\s*[:#]?\s*[\w-]+\b", 0.9, "ID"),
    ("confidential", r"\b(?:confidential|proprietary|trade secret|NDA|do not distribute)\b", 0.8, None),
    ("internal_only", r"\b(?:internal (?:use )?only|restricted)\b", 0.8, None),
    # names / orgs (NER-lite)
    ("honorific_name", r"\b(?:Mr|Mrs|Ms|Dr|Prof)\.\s+[A-Z][a-z]+(?:\s+[A-Z][a-z]+)?", 0.8, "PERSON"),
    # maximal run of capitalized words, refined in stage1 (leading sentence
    # furniture like "Patient"/"Analyze" is stripped before use)
    ("full_name", r"\b(?:[A-Z][a-z]{2,}\s+){1,3}[A-Z][a-z]{2,}\b", 0.6, "PERSON"),
    ("org_suffix", r"\b[A-Z][\w&]+(?:\s+[A-Z][\w&]+)*\s+(?:Inc|LLC|Ltd|Corp|GmbH|LLP)\b\.?", 0.6, "ORG"),
    ("hospital", r"\b[A-Z][a-z]+\s+(?:Hospital|Clinic|Medical Center)\b", 0.8, "ORG"),
    # geo
    ("city", r"\b(?:Chicago|New York|London|Berlin|Mumbai|Bangalore|Paris|Tokyo|Seattle|Austin|Boston|Denver)\b", 0.5, "LOCATION"),
    # misc ids
    ("vin", r"\b[A-HJ-NPR-Z0-9]{17}\b", 0.7, "ID"),
    ("plate", r"\b[A-Z]{2,3}[- ]\d{3,4}\b", 0.6, "ID"),
    ("imei", r"\bIMEI[:\s#]+\d{14,16}\b", 0.8, "ID"),
    ("device_serial", r"\bserial(?:\s+number)?[:\s#]+[A-Z0-9-]{6,}\b", 0.6, "ID"),
    ("geo_coord", r"\b-?\d{1,3}\.\d{3,},\s*-?\d{1,3}\.\d{3,}\b", 0.8, "LOCATION"),
    ("url_auth", r"https?://[^\s]*(?:token|key|auth)=[^\s&]+", 0.9, "ID"),
    ("employee_id", r"\b(?:EMP|employee id)[:\s#]+\w+\b", 0.7, "ID"),
    ("tax_id", r"\b(?:EIN|TIN)[:\s#]+\d{2}-?\d{7}\b", 0.9, "FINANCIAL"),
    ("crypto_addr", r"\b(?:0x[a-fA-F0-9]{40}|[13][a-km-zA-HJ-NP-Z1-9]{25,34})\b", 0.8, "FINANCIAL"),
    ("source_code", r"\b(?:def |class |import |function\s*\(|#include)\b", 0.5, None),
    ("secret_project", r"\bproject\s+[A-Z][a-z]+\b", 0.6, "ORG"),
]

PATTERNS = [(n, re.compile(rx), s, t) for n, rx, s, t in _P]
NUM_PATTERNS = len(PATTERNS)

# identity-bearing pattern names for the HIPAA compound rule
_IDENTITY = {"email", "phone_us", "phone_intl", "ssn", "passport", "dob",
             "address", "honorific_name", "full_name", "mrn", "patient_ref",
             "employee_id"}
_MEDICAL = {"icd10", "diagnosis", "conditions", "medications", "phi_terms",
            "hospital"}

# leading words that are sentence furniture, not part of a name
_NAME_STOPWORDS = {"Patient", "Doctor", "Nurse", "Dear", "The", "Hello",
                   "Hi", "Mr", "Mrs", "Ms", "Dr", "Prof", "Attn", "From",
                   "To", "Re", "Regarding", "Find", "Analyze", "Summarize",
                   "Draft", "Review", "Retrieve", "Search", "Compare",
                   "Explain", "What", "How", "General"}


def _refine_name(text: str):
    """Trim leading non-name capitalized words from a full_name match; the
    remainder (if still a plausible name) is the entity."""
    toks = text.split()
    while toks and toks[0].rstrip(".") in _NAME_STOPWORDS:
        toks = toks[1:]
    if len(toks) >= 1 and all(t[0].isupper() for t in toks):
        return " ".join(toks) if toks else None
    return None

# stage-2 class floors (paper Sec VII-A)
CLASS_SENSITIVITY = {"public": 0.2, "internal": 0.5,
                     "confidential": 0.8, "restricted": 1.0}


@dataclass
class SensitivityReport:
    score: float
    stage1: float
    stage2: float
    stage2_class: str
    matches: list            # (pattern_name, matched_text, floor, ptype)
    entities: list           # (entity_text, placeholder_type)


class MIST:
    def __init__(self, classifier=None, crashed: bool = False):
        """classifier: optional repro.core.mist_model.NgramClassifier.
        ``crashed=True`` simulates agent failure -> conservative fallback."""
        self.classifier = classifier
        self.crashed = crashed

    # ------------------------------------------------------------ scoring
    def stage1(self, text: str):
        floor = 0.0
        matches = []
        entities = []
        hit_names = set()
        for name, rx, sens, ptype in PATTERNS:
            for m in rx.finditer(text):
                ent = m.group(0)
                if name == "full_name":
                    refined = _refine_name(ent)
                    if refined is None or len(refined.split()) < 2:
                        continue
                    ent = refined
                hit_names.add(name)
                matches.append((name, ent, sens, ptype))
                floor = max(floor, sens)
                if ptype is not None:
                    entities.append((ent, ptype))
        # HIPAA compound rule: medical content + identity => PHI (>=0.9)
        if hit_names & _MEDICAL and hit_names & _IDENTITY:
            floor = max(floor, 0.9)
        return floor, matches, entities

    def stage2(self, text: str):
        if self.classifier is not None:
            cls = self.classifier.classify(text)
        else:
            cls = _heuristic_class(text)
        return CLASS_SENSITIVITY[cls], cls

    def analyze(self, text: str) -> SensitivityReport:
        if self.crashed:
            # conservative fallback: assume everything is sensitive
            return SensitivityReport(1.0, 1.0, 1.0, "restricted", [], [])
        s1, matches, entities = self.stage1(text)
        s2, cls = self.stage2(text)
        return SensitivityReport(max(s1, s2), s1, s2, cls, matches, entities)

    # ------------------------------------------------------- sanitization
    def sanitize(self, texts, store: Optional[PlaceholderStore] = None,
                 seed: Optional[int] = None):
        """Forward pass tau(h_r): returns (sanitized_texts, store)."""
        store = store or PlaceholderStore(seed=seed)
        out = []
        for t in ([texts] if isinstance(texts, str) else list(texts)):
            _, _, entities = self.stage1(t)
            out.append(store.apply(t, entities))
        if isinstance(texts, str):
            return out[0], store
        return out, store

    def desanitize(self, text: str, store: PlaceholderStore) -> str:
        """Backward pass: restore placeholders in a model response."""
        return store.restore(text)


_RESTRICTED_KW = re.compile(
    r"\b(?:patient|diagnos|privileged|private key|password|ssn)\b", re.I)
_CONF_KW = re.compile(
    r"\b(?:confidential|proprietary|salary|internal|customer data|source code)\b",
    re.I)
_INTERNAL_KW = re.compile(
    r"\b(?:roadmap|meeting notes|draft|review|deploy|our team|our codebase)\b",
    re.I)


def _heuristic_class(text: str) -> str:
    if _RESTRICTED_KW.search(text):
        return "restricted"
    if _CONF_KW.search(text):
        return "confidential"
    if _INTERNAL_KW.search(text):
        return "internal"
    return "public"
