"""SQL front end: lexer, parser, logical plans, analyzer, optimizer."""
