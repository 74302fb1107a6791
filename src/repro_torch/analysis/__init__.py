"""Runtime checks of the port's serving invariants (port of the
framework-free part of ``repro/analysis``): the allocator's shadow page
ledger."""
from .ledger import LedgerError, PageLedger, attach_ledger, sanitize_enabled
