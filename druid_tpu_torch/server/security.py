"""Security SPI chain: Authenticator → Authorizer (+ Escalator); the port's
own copy of the reference package's `server/security.py` (stdlib only).

Reference analogs (server/src/main/java/org/apache/druid/server/security/):
  Authenticator.java / AuthenticatorMapper — ordered credential checkers;
    the first one that recognizes the request wins
  Authorizer.java / AuthorizationUtils.authorizeAllResourceActions — maps an
    authenticated identity to per-(resource, action) decisions
  Escalator.java — the internal identity services use for
    service-to-service calls (so cluster-internal fan-out is never blocked
    by user-level ACLs)
  Resource.java / Action.java / ResourceAction.java — the resource model

The chain plugs into QueryLifecycle via `authorizer_for_query` and into the
HTTP layer via `AuthChain.authenticate(headers)`.
"""
from __future__ import annotations

import base64
import fnmatch
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

READ = "READ"
WRITE = "WRITE"

DATASOURCE = "DATASOURCE"
CONFIG = "CONFIG"
STATE = "STATE"


@dataclass(frozen=True)
class Resource:
    name: str
    type: str = DATASOURCE


@dataclass(frozen=True)
class ResourceAction:
    resource: Resource
    action: str


@dataclass(frozen=True)
class AuthenticationResult:
    """Who the caller is and which authorizer decides for them
    (reference: AuthenticationResult.java)."""
    identity: str
    authorizer_name: str = "allowAll"
    context: Tuple = ()


class AuthenticationFailed(Exception):
    """Credentials were PRESENT for this authenticator but invalid — the
    chain must deny the request, not fall through to a weaker
    authenticator (reference BasicHTTPAuthenticator skipOnFailure=false)."""


class Authenticator:
    """SPI: inspect request headers, return an AuthenticationResult, None
    ('not mine'; the chain moves to the next authenticator), or raise
    AuthenticationFailed (mine, and wrong — terminal deny)."""

    name = "base"

    def authenticate(self, headers: Dict[str, str]
                     ) -> Optional[AuthenticationResult]:
        raise NotImplementedError


class AllowAllAuthenticator(Authenticator):
    name = "allowAll"

    def __init__(self, authorizer_name: str = "allowAll"):
        self.authorizer_name = authorizer_name

    def authenticate(self, headers):
        return AuthenticationResult("allowAll", self.authorizer_name)


class BasicHTTPAuthenticator(Authenticator):
    """HTTP Basic credentials against a user→password map (the capability
    of extensions-core/druid-basic-security's BasicHTTPAuthenticator)."""

    name = "basic"

    def __init__(self, users: Dict[str, str],
                 authorizer_name: str = "allowAll"):
        self.users = dict(users)
        self.authorizer_name = authorizer_name

    def authenticate(self, headers):
        auth = headers.get("Authorization") or headers.get("authorization")
        if not auth or not auth.startswith("Basic "):
            return None
        try:
            user, _, pw = base64.b64decode(auth[6:]).decode().partition(":")
        except Exception:
            raise AuthenticationFailed("malformed Basic credentials")
        if self.users.get(user) == pw:
            return AuthenticationResult(user, self.authorizer_name)
        # present-but-wrong credentials must not launder into a weaker
        # authenticator downstream
        raise AuthenticationFailed(f"bad credentials for {user!r}")


class Authorizer:
    """SPI: one (identity, resource, action) decision."""

    def authorize(self, auth: AuthenticationResult, resource: Resource,
                  action: str) -> bool:
        raise NotImplementedError


class AllowAllAuthorizer(Authorizer):
    def authorize(self, auth, resource, action):
        return True


@dataclass
class Permission:
    resource_pattern: str       # fnmatch over resource name
    resource_type: str = DATASOURCE
    actions: Tuple[str, ...] = (READ, WRITE)

    def grants(self, resource: Resource, action: str) -> bool:
        return (resource.type == self.resource_type
                and action in self.actions
                and fnmatch.fnmatchcase(resource.name, self.resource_pattern))


class RoleBasedAuthorizer(Authorizer):
    """identity → roles → permissions (basic-security RBAC capability)."""

    def __init__(self, role_permissions: Dict[str, Sequence[Permission]],
                 user_roles: Dict[str, Sequence[str]]):
        self.role_permissions = {r: list(p)
                                 for r, p in role_permissions.items()}
        self.user_roles = {u: list(r) for u, r in user_roles.items()}

    def authorize(self, auth, resource, action):
        for role in self.user_roles.get(auth.identity, ()):
            for perm in self.role_permissions.get(role, ()):
                if perm.grants(resource, action):
                    return True
        return False


class Escalator:
    """Internal service-to-service identity (reference Escalator.java):
    cluster-internal calls run as this identity, never as the end user."""

    def __init__(self, identity: str = "druid_internal",
                 authorizer_name: str = "allowAll"):
        self._result = AuthenticationResult(identity, authorizer_name)

    def escalate(self) -> AuthenticationResult:
        return self._result


class AuthChain:
    """Ordered authenticators + named authorizers — the AuthenticatorMapper
    / AuthorizerMapper pair."""

    def __init__(self, authenticators: Sequence[Authenticator] = (),
                 authorizers: Optional[Dict[str, Authorizer]] = None,
                 escalator: Optional[Escalator] = None):
        self.authenticators = list(authenticators) or [AllowAllAuthenticator()]
        self.authorizers = dict(authorizers or {"allowAll": AllowAllAuthorizer()})
        self.escalator = escalator or Escalator()

    def authenticate(self, headers: Dict[str, str]
                     ) -> Optional[AuthenticationResult]:
        for a in self.authenticators:
            try:
                result = a.authenticate(headers)
            except AuthenticationFailed:
                return None      # terminal deny: no fall-through
            if result is not None:
                return result
        return None

    def authorize_all(self, auth: AuthenticationResult,
                      resource_actions: Sequence[ResourceAction]) -> bool:
        zer = self.authorizers.get(auth.authorizer_name)
        if zer is None:
            return False
        return all(zer.authorize(auth, ra.resource, ra.action)
                   for ra in resource_actions)


def resource_actions_for_query(query) -> List[ResourceAction]:
    """The datasources a query reads (incl. unions and nested inner
    queries) as READ resource-actions
    (AuthorizationUtils.authorizeAllResourceActions inputs)."""
    out: List[ResourceAction] = []
    seen = set()

    def add(q):
        for ds in (q.union_datasources or (q.datasource,)):
            # the synthetic nested-query datasource is not a resource;
            # the INNER query's real tables are what gets authorized
            if ds and ds != "__subquery__" and ds not in seen:
                seen.add(ds)
                out.append(ResourceAction(Resource(ds, DATASOURCE), READ))
        if q.inner_query is not None:
            add(q.inner_query)

    add(query)
    return out


def authorizer_for_query(chain: AuthChain):
    """Adapter to QueryLifecycle's (identity, query) -> bool hook: looks the
    identity back up through the chain's authenticated results by treating
    identity as pre-authenticated (the HTTP layer authenticates; this
    authorizes)."""
    def check(auth: Optional[AuthenticationResult], query) -> bool:
        if auth is None:
            return False
        if isinstance(auth, str):
            # pre-chain callers pass a bare identity: authorize it under
            # the default authorizer
            auth = AuthenticationResult(auth, "allowAll")
        return chain.authorize_all(auth, resource_actions_for_query(query))
    return check
