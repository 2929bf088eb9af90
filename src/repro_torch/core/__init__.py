"""Fed-CHS protocol: keys, topology, scheduler, ledger, round engine, driver."""
