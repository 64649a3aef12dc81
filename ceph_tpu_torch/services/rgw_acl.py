"""S3 access-control model: owners, grants, canned ACLs.

Role of the reference's ``src/rgw/rgw_acl.h`` / ``rgw_acl_s3.cc``
(ACLOwner + RGWAccessControlPolicy + canned-ACL expansion) and the
verify_*_permission checks in ``src/rgw/rgw_op.cc``.  The model is
deliberately the S3 ACL subset (not IAM policy documents): an owner
plus a grant list, where a grantee is a concrete user (access key), the
AllUsers group, or the AuthenticatedUsers group.

Serialized form (index entries / bucket xattrs) is a compact text
line — ``grantee:PERM;grantee:PERM`` — chosen over XML so object index
rows stay small; the XML AccessControlPolicy shape exists only at the
REST boundary.

ceph_tpu_torch's own copy of ``ceph_tpu/services/rgw_acl.py``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

# grantee namespace: a literal access key, or one of the two groups
ALL_USERS = "*"          # S3 AllUsers URI (anonymous included)
AUTH_USERS = "@auth"     # S3 AuthenticatedUsers URI

_URI = {
    ALL_USERS: "http://acs.amazonaws.com/groups/global/AllUsers",
    AUTH_USERS:
        "http://acs.amazonaws.com/groups/global/AuthenticatedUsers",
}
_URI_REV = {v: k for k, v in _URI.items()}

PERMS = ("READ", "WRITE", "READ_ACP", "WRITE_ACP", "FULL_CONTROL")

#: canned ACL -> grants beyond the owner's implicit FULL_CONTROL
#: (rgw_acl_s3.cc create_canned role)
CANNED = {
    "private": [],
    "public-read": [(ALL_USERS, "READ")],
    "public-read-write": [(ALL_USERS, "READ"), (ALL_USERS, "WRITE")],
    "authenticated-read": [(AUTH_USERS, "READ")],
}


class Acl:
    """An owner plus a grant list.  The owner always holds
    FULL_CONTROL regardless of the grant list (S3 semantics: you
    cannot lock yourself out of your own ACL)."""

    def __init__(self, owner: str = "",
                 grants: list[tuple[str, str]] | None = None):
        self.owner = owner
        self.grants = list(grants or [])

    # ------------------------------------------------------ authorization

    def allows(self, principal: str | None, perm: str) -> bool:
        """Does ``principal`` (None = anonymous) hold ``perm``?

        An UNSET policy (no owner, no grants — a bucket/object created
        before ACLs or through the library API) admits every
        authenticated principal and no anonymous one: exactly the
        pre-ACL frontend behavior, so legacy data keeps its access
        semantics."""
        if not self.owner and not self.grants:
            return principal is not None
        if principal is not None and principal == self.owner:
            return True
        for grantee, p in self.grants:
            if p != perm and p != "FULL_CONTROL":
                continue
            if grantee == ALL_USERS:
                return True
            if grantee == AUTH_USERS and principal is not None:
                return True
            if principal is not None and grantee == principal:
                return True
        return False

    # -------------------------------------------------------- (de)coding

    def dump(self) -> str:
        return ";".join(f"{g}:{p}" for g, p in self.grants)

    @classmethod
    def parse(cls, owner: str, text: str) -> "Acl":
        grants = []
        for part in text.split(";"):
            if not part:
                continue
            g, _, p = part.rpartition(":")
            if p in PERMS:
                grants.append((g, p))
        return cls(owner, grants)

    @classmethod
    def canned(cls, owner: str, name: str) -> "Acl":
        """Expand a canned ACL name; unknown names raise KeyError so
        the frontend can answer InvalidArgument."""
        return cls(owner, CANNED[name])

    # --------------------------------------------------------------- XML

    def to_xml(self) -> bytes:
        root = ET.Element("AccessControlPolicy")
        ow = ET.SubElement(root, "Owner")
        ET.SubElement(ow, "ID").text = self.owner
        lst = ET.SubElement(root, "AccessControlList")
        for g, p in [(self.owner, "FULL_CONTROL")] + self.grants:
            gr = ET.SubElement(lst, "Grant")
            ge = ET.SubElement(gr, "Grantee")
            if g in _URI:
                ge.set("{http://www.w3.org/2001/XMLSchema-instance}"
                       "type", "Group")
                ET.SubElement(ge, "URI").text = _URI[g]
            else:
                ge.set("{http://www.w3.org/2001/XMLSchema-instance}"
                       "type", "CanonicalUser")
                ET.SubElement(ge, "ID").text = g
            ET.SubElement(gr, "Permission").text = p
        return ET.tostring(root)

    @classmethod
    def from_xml(cls, body: bytes, owner: str = "") -> "Acl":
        """Namespace-agnostic parse: real S3 SDK bodies carry the
        default ``http://s3.amazonaws.com/doc/2006-03-01/`` xmlns,
        which would make literal tag lookups match nothing (and a PUT
        ?acl silently wipe every grant) — so elements are matched on
        LOCAL name.

        ``owner`` is the PERSISTED owner: only that identity's
        FULL_CONTROL grant is elided as implicit.  Comparing against
        the body's self-declared Owner instead would let a grantee
        name themselves owner and have their real grant silently
        dropped."""
        def local(el):
            return el.tag.rsplit("}", 1)[-1]

        def child(el, name):
            for ch in el:
                if local(ch) == name:
                    return ch
            return None

        def text(el, name):
            ch = None if el is None else child(el, name)
            return (ch.text or "") if ch is not None else ""

        root = ET.fromstring(body)
        body_owner = text(child(root, "Owner"), "ID")
        grants: list[tuple[str, str]] = []
        for gr in root.iter():
            if local(gr) != "Grant":
                continue
            # a malformed grant is an ERROR (S3 MalformedACLError),
            # never silently dropped — a typoed permission must not
            # turn a policy private behind a 200
            perm = text(gr, "Permission")
            if perm not in PERMS:
                raise ValueError(f"bad permission {perm!r}")
            ge = child(gr, "Grantee")
            if ge is None:
                raise ValueError("grant without grantee")
            uri = text(ge, "URI")
            if uri and uri not in _URI_REV:
                raise ValueError(f"unknown grantee group {uri!r}")
            g = _URI_REV.get(uri, text(ge, "ID"))
            if not g:
                raise ValueError("grantee names no user or group")
            if owner and g == owner and perm == "FULL_CONTROL":
                continue  # the owner's implicit grant; don't store it
            grants.append((g, perm))
        return cls(owner or body_owner, grants)
