from .cli.main import main
import sys

sys.exit(main())
